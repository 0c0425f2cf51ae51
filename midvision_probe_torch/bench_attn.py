"""Attention bench of the PyTorch port (counterpart of the repository's
``launch_script/bench_attn.py``).

Usage::

    python -m midvision_probe_torch.bench_attn [--batch 64] [--n-valid 1201] \\
        [--heads 12] [--hd 64] [--iters 20] [--variants base wide4 ...] \\
        [--no-oracle] [--device cpu]

It times attention variants on the ViT-B/16 probing shape at 480x640
(B=64, n_valid=1201 tokens padded to N=1280, H=12, d=64, bf16 qkv made
from ``np.random.RandomState(0)``, ``randn * 0.6``):

* ``base``: the port's fused-qkv attention (K1, ``ops/vit_attention.py``);
* ``wide<G>`` / ``stagger<G>``: ``wide_attention`` (K7) with G heads per
  kernel block (width G*d), without / with the cross-head prefetch;
* ``int8``: ``int8_attention`` (K8), QK^T in int8 with per-head scales;
* ``splash``: ``splash_attention`` (K9), exact softmax over the valid keys.

K7 and K8 compute the bench's clamped exp2 attention: ``exp2(min(s, 110))``
with no max subtraction, keys >= n_valid masked, ``l = max(sum p, 1e-30)``,
``o = (bf16(p) v) / l``. Each takes one of two routes by head dim
(``wide_route``, ``int8_route``), counted in
``ops.vit_attention.route_launches`` as the kernel reports it: ``wgmma``,
the attention kernel of ``csrc/vit_attention.cu`` in its clamped mode (K7
at d = 64 and 80, entry ``mvp_clamp_attention``; K8 at d = 64 with QK^T in
int8, entry ``mvp_int8_attention_wgmma``), and ``mma_sync``,
``csrc/bench_attn.cu`` (K7 at every other multiple of 8 up to 128, K8 at d
= 8, 16, 32 and 128). K8 on ``wgmma`` takes its exp2 from the MUFU with
subnormal results flushed to 0, which moves no output by more than
``n_valid * 2^-126 * max|v| / 1e-30``. K8's prologue
(``quantize_qk_heads``: per-head scales and int8 q and k, head-major and
zero-padded to 32-byte rows) is two kernels of ``csrc/bench_attn.cu``. K9
runs the strided attention kernel of
``csrc/vit_attention.cu`` (K2's) on ``bf16(q * scale)`` with scale 1 and
``n_valid``.

Per variant it prints the time per call on the host clock (synchronised
every iteration, so it includes one host round trip), that time less the
round-trip floor (a one-element add, timed the same way), the useful
TFLOP/s (4*B*H*n_valid^2*d per call) and the max abs error against an f32
oracle over the valid rows; ``main`` returns the same numbers as a list of
dicts. It runs on the card by default (and raises without one);
``--device cpu`` runs the plain versions, whose times are the CPU's.

Every wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); each counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import time

import numpy as np
import torch

from midvision_probe_torch.ops.cuda_build import float_bits, load_library
from midvision_probe_torch.ops.vit_attention import (
    ROUTES,
    WGMMA_HEAD_DIMS,
    _vit_attention_plain,
    fused_qkv_attention,
    launch_attention,
    route_launches,
)
from midvision_probe_torch.utils.device import resolve_device

_LOG2E = math.log2(math.e)
_CLAMP = 110.0  # exp2(110) * n_valid stays inside f32's range
_L_FLOOR = 1e-30
INT8_HEAD_DIMS = (8, 16, 32, 64, 128)  # K8: every head dim the JAX kernel takes up to 128
WIDE_HEAD_DIMS = tuple(range(8, 129, 8))  # K7: every multiple of 8 up to 128


def wide_route(d: int) -> str:
    """The route of K7 at head dim ``d`` on a card: ``"wgmma"`` at d in
    ``WGMMA_HEAD_DIMS`` (the attention kernel's clamped mode), else
    ``"mma_sync"`` (``csrc/bench_attn.cu``, instantiated at d rounded up to
    16). Raises on what neither takes."""
    if d not in WIDE_HEAD_DIMS:
        raise ValueError(f"wide_attention: head dim {d} is not a multiple of 8 in [8, 128]")
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma_sync"


def int8_route(d: int) -> str:
    """The route of K8 at head dim ``d`` on a card: ``"wgmma"`` at d = 64
    (the attention kernel's clamped mode with an s8 QK^T), else
    ``"mma_sync"`` (``csrc/bench_attn.cu``). Raises on what neither takes."""
    if d not in INT8_HEAD_DIMS:
        raise ValueError(f"int8_attention: head dim {d} not in {INT8_HEAD_DIMS}")
    return "wgmma" if d == 64 else "mma_sync"


def int8_row_bytes(d: int) -> int:
    """The bytes of one head's row of the prologue's q8 and k8: d rounded up
    to a multiple of 32 (the s8 products take k in steps of 32 bytes)."""
    return -(-d // 32) * 32


# ------------------------------------------------------------ plain versions


def _clamp_exp2_pv(s2: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bench kernels' softmax-free attention on base-2 scores ``s2``
    (B, H, N, n_valid) f32 over the valid keys and v (B, N, H, d):
    ``p = exp2(min(s2, 110))``, ``l = max(sum p, 1e-30)``,
    ``o = (bf16(p) v) / l`` with f32 products (TF32 off on a card), rounded
    to v's dtype -> (B, N, H*d). Leaving out the keys >= n_valid equals the
    kernels' mask (their -inf scores give p = 0, their values are zeroed)."""
    B, N, H, d = v.shape
    p = torch.exp2(torch.clamp(s2, max=_CLAMP))
    l = p.sum(-1, keepdim=True).clamp_min(_L_FLOOR)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                     v[:, :s2.shape[-1]].float())
    return (o / l).transpose(1, 2).reshape(B, N, H * d).to(v.dtype)


def wide_scores(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """K7's base-2 scores (B, H, N, n_valid) f32: ``q' = bf16(f32(q) *
    scale * log2(e))``, ``s = q' k^T`` over the valid keys."""
    q, k, _ = qkv.unbind(2)  # (B, N, H, d)
    q = (q.float() * (scale * _LOG2E)).to(qkv.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, :n_valid].float())


def _wide_attention_plain(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """K7's function: ``wide_scores`` then ``_clamp_exp2_pv``."""
    return _clamp_exp2_pv(wide_scores(qkv, scale, n_valid), qkv[:, :, 2])


def quantize_qk(qkv: torch.Tensor, scale: float, n_valid: int):
    """K8's prologue, as the JAX code runs it outside its kernel: per-head
    amax of q and k over the valid rows of the whole batch, ``s = max(amax,
    1e-8) / 127``, ``int8 = clip(round_half_even(x / s), -127, 127)`` (a
    division by s, not a multiply by its reciprocal), ``c[h] = scale *
    log2(e) * qs[h] * ks[h]``. Returns q8, k8 (B, N, H, d) int8 and c (H,)
    f32.

    XLA compiles the JAX code's ``/ 127.0`` (a division by a constant) into
    a multiply by the f32 reciprocal, which differs from the division in the
    last bit for some amax; the port multiplies the same way, so its int8
    tensors equal the JAX function's bit for bit (c within two f32 ulps:
    XLA also folds scale * log2(e) / 127 into one constant)."""
    q, k, _ = qkv.unbind(2)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)  # rounded to f32 first
    qs = q[:, :n_valid].float().abs().amax(dim=(0, 1, 3)).clamp_min(1e-8) * inv127
    ks = k[:, :n_valid].float().abs().amax(dim=(0, 1, 3)).clamp_min(1e-8) * inv127
    c = (scale * _LOG2E) * qs * ks

    def quant(x, s):
        return torch.clamp(torch.round(x.float() / s[None, None, :, None]), -127, 127).to(
            torch.int8)

    return quant(q, qs), quant(k, ks), c


def _heads_padded(x8: torch.Tensor, dp: int) -> torch.Tensor:
    """(B, N, H, d) -> (B, H, N, dp) with zeros in the columns >= d."""
    B, N, H, d = x8.shape
    out = x8.new_zeros((B, H, N, dp))
    out[..., :d] = x8.transpose(1, 2)
    return out


def int8_scores(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """K8's base-2 scores (B, H, N, n_valid) f32: ``f32(q8 k8^T) * c[h]``
    over the valid keys (the int8 products summed in f32 are exact:
    |s| <= d * 127^2 < 2^24)."""
    q8, k8, c = quantize_qk(qkv, scale, n_valid)
    s32 = torch.einsum("bqhd,bkhd->bhqk", q8.float(), k8[:, :n_valid].float())
    return s32 * c[None, :, None, None]


def _int8_attention_plain(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """K8's function: ``int8_scores`` then ``_clamp_exp2_pv``."""
    return _clamp_exp2_pv(int8_scores(qkv, scale, n_valid), qkv[:, :, 2])


def _splash_q(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """``bf16(f32(q) * scale)``, the q that K9's scores see, (B, N, H, d)
    (on a card the kernel rounds it itself)."""
    return (qkv[:, :, 0].float() * scale).to(qkv.dtype)


def _splash_attention_plain(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """K9's function: exact softmax attention with scale 1 of
    ``bf16(q * scale)`` over the keys < n_valid, for every query row."""
    B, N, _, H, d = qkv.shape
    q = _splash_q(qkv, scale).transpose(1, 2)
    k, v = (t.transpose(1, 2)[:, :, :n_valid] for t in qkv[:, :, 1:].unbind(2))
    return _vit_attention_plain(q, k, v, 1.0).transpose(1, 2).reshape(B, N, H * d)


def f32_oracle(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """Exact softmax attention in f32 over the keys < n_valid (TF32 off on
    a card) -> (B, N, H*d) f32."""
    B, N, _, H, d = qkv.shape
    q, k, v = qkv.float().unbind(2)
    k, v = k[:, :n_valid], v[:, :n_valid]
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q * scale, k), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, H * d)


# ------------------------------------------------------------------ wrappers


def _check_qkv(qkv: torch.Tensor, n_valid: int, width: int | None = None):
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, d), got {tuple(qkv.shape)}")
    B, N, _, H, d = qkv.shape
    if not 0 < n_valid <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if width is not None and ((H * d) % width or width % d):
        raise ValueError(f"width {width} must be a multiple of d={d} dividing H*d={H * d}")
    return B, N, H, d


def _check_card(qkv: torch.Tensor, name: str, route) -> str:
    """What the bench kernels take: a contiguous, 16-byte aligned bf16
    tensor on a card, a head dim that ``route`` (``wide_route`` or
    ``int8_route``) takes, no gradient. Returns the route."""
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{name}: dtype {qkv.dtype}, the kernel takes bfloat16")
    chosen = route(qkv.shape[-1])
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} is forward-only; run it under torch.no_grad()")
    return chosen


def _entry(name: str, argtypes, library: str = "bench_attn"):
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def wide_attention(qkv: torch.Tensor, scale: float, n_valid: int, width: int = 256,
                   stagger: bool = False) -> torch.Tensor:
    """K7: the clamped exp2 attention on qkv (B, N, 3, H, d) bf16 ->
    (B, N, H*d). ``width`` (a multiple of d dividing H*d) and ``stagger``
    schedule the work and do not change the result: ``width / d`` heads of
    one query tile are taken by one block in turn; ``stagger`` loads the
    next head's first tiles while the current head's last is consumed. On
    the ``wgmma`` route (``wide_route``) ``stagger`` has no counterpart: the
    producer warpgroup always runs ahead across heads, so both settings run
    the same schedule."""
    B, N, H, d = _check_qkv(qkv, n_valid, width)
    if qkv.device.type == "cpu":
        return _wide_attention_plain(qkv, scale, n_valid)
    route = _check_card(qkv, "wide_attention", wide_route)
    out = torch.empty((B, N, H * d), dtype=qkv.dtype, device=qkv.device)
    ran = ctypes.c_int(-1)
    head = [qkv.data_ptr(), out.data_ptr(), B, N, H, d, n_valid, width // d]
    if route == "wgmma":
        fn = _entry("mvp_clamp_attention", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p], "vit_attention")
    else:
        fn = _entry("mvp_wide_attention", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        head.append(int(stagger))
    with torch.cuda.device(qkv.device):
        err = fn(*head, float_bits(scale * _LOG2E), ctypes.byref(ran),
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on(err, "wide_attention")
    wide_attention.launches += 1
    route_launches[ROUTES[ran.value]] += 1
    return out


wide_attention.launches = 0  # kernel launches (never the plain version)


def quantize_qk_heads(qkv: torch.Tensor, scale: float, n_valid: int):
    """K8's prologue in the layout its attention kernels read: ``quantize_qk``'s
    q8 and k8 head-major, (B, H, N, dp) int8 with each row zero-padded to
    ``dp = int8_row_bytes(d)``, and c (H,) f32. On a card the two kernels of
    ``csrc/bench_attn.cu`` (``amax_qk``: the per-head max |x| over the valid
    rows; ``quantize_qk``: the scales, the IEEE division, round half to even,
    the clamp, and c), equal to ``quantize_qk`` bit for bit (c within two f32
    ulps); for a CPU tensor its plain version (``quantize_qk`` laid out)."""
    B, N, H, d = _check_qkv(qkv, n_valid)
    dp = int8_row_bytes(d)
    if qkv.device.type == "cpu":
        q8, k8, c = quantize_qk(qkv, scale, n_valid)
        return _heads_padded(q8, dp), _heads_padded(k8, dp), c
    _check_card(qkv, "int8_attention", int8_route)
    dev = qkv.device
    q8 = torch.empty((B, H, N, dp), dtype=torch.int8, device=dev)
    k8 = torch.empty_like(q8)
    c = torch.empty((H,), dtype=torch.float32, device=dev)
    amax = torch.empty((2 * H,), dtype=torch.int32, device=dev)  # zeroed by the entry point
    fn = _entry("mvp_quantize_qk", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(qkv.data_ptr(), amax.data_ptr(), q8.data_ptr(), k8.data_ptr(), c.data_ptr(),
                 B, N, H, d, dp, n_valid, float_bits(scale * _LOG2E),
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "quantize_qk_heads")
    quantize_qk_heads.launches += 1
    return q8, k8, c


quantize_qk_heads.launches = 0  # prologue launches (never the plain version)


def _launch_int8(q8: torch.Tensor, k8: torch.Tensor, c: torch.Tensor, qkv: torch.Tensor,
                 n_valid: int, width: int) -> torch.Tensor:
    """K8's attention kernel alone on ``quantize_qk_heads``' output (v read
    from qkv), on its route (``int8_route``)."""
    B, N, _, H, d = qkv.shape
    out = torch.empty((B, N, H * d), dtype=qkv.dtype, device=qkv.device)
    ran = ctypes.c_int(-1)
    args = [q8.data_ptr(), k8.data_ptr(), qkv.data_ptr(), c.data_ptr(), out.data_ptr(),
            B, N, H, d]
    if int8_route(d) == "wgmma":
        fn = _entry("mvp_int8_attention_wgmma", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p], "vit_attention")
    else:
        fn = _entry("mvp_int8_attention", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        args.append(q8.shape[-1])
    with torch.cuda.device(qkv.device):
        err = fn(*args, n_valid, width // d, ctypes.byref(ran),
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on(err, "int8_attention")
    int8_attention.launches += 1
    route_launches[ROUTES[ran.value]] += 1
    return out


def int8_attention(qkv: torch.Tensor, scale: float, n_valid: int,
                   width: int = 128) -> torch.Tensor:
    """K8: the clamped exp2 attention with QK^T in int8 (the prologue
    ``quantize_qk_heads``, then the attention kernel) -> (B, N, H*d)."""
    _check_qkv(qkv, n_valid, width)
    if qkv.device.type == "cpu":
        return _int8_attention_plain(qkv, scale, n_valid)
    return _launch_int8(*quantize_qk_heads(qkv, scale, n_valid), qkv, n_valid, width)


int8_attention.launches = 0  # kernel launches, counted in _launch_int8 (never the plain version)


def splash_attention(qkv: torch.Tensor, scale: float, n_valid: int) -> torch.Tensor:
    """K9: exact softmax attention of ``bf16(q * scale)`` with scale 1 over
    the keys < n_valid -> (B, N, H*d); on a card the strided attention
    kernel on (B, H, N, d) views of qkv, which rounds ``q * scale`` to bf16
    itself (``q_scale``), counted here."""
    B, N, H, d = _check_qkv(qkv, n_valid)
    if qkv.device.type == "cpu":
        return _splash_attention_plain(qkv, scale, n_valid)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    out = launch_attention(q, k, v, 1.0, n_valid, q_scale=scale)  # a view of (B, N, H, d)
    splash_attention.launches += 1
    return out.transpose(1, 2).reshape(B, N, H * d)


splash_attention.launches = 0  # kernel launches (never the plain version)


# --------------------------------------------------------------------- bench


def time_call(fn, *args, iters: int = 20) -> float:
    """Median host seconds per call, each iteration ended by fetching one
    element of the output to the host (which waits for the device)."""
    float(fn(*args).reshape(-1)[0])
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        float(out.reshape(-1)[0])
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


DEFAULT_VARIANTS = ("base", "wide4", "stagger4", "wide12", "int8")


def _variant(name: str, qkv: torch.Tensor, scale: float, n_valid: int):
    """The call that bench variant ``name`` times, or None if unknown."""
    if name == "base":
        return lambda: fused_qkv_attention(qkv, scale, n_valid)
    if name == "int8":
        return lambda: int8_attention(qkv, scale, n_valid)
    if name == "splash":
        return lambda: splash_attention(qkv, scale, n_valid)
    for prefix, stagger in (("wide", False), ("stagger", True)):
        heads = name[len(prefix):]
        if name.startswith(prefix) and heads.isdigit():
            width = int(heads) * qkv.shape[-1]
            return lambda: wide_attention(qkv, scale, n_valid, width=width, stagger=stagger)
    return None


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-valid", type=int, default=1201)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--hd", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", nargs="*", default=list(DEFAULT_VARIANTS))
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the f32 oracle (its (B, H, N, n_valid) f32 scores "
                         "outgrow device memory at large --batch)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu (the "
                         "plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    B, H, d = args.batch, args.heads, args.hd
    nv = args.n_valid
    N = ((nv + 127) // 128) * 128
    scale = d**-0.5
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(B, N, 3, H, d).astype(np.float32) * 0.6).to(
        device, torch.bfloat16)
    flops = 4.0 * B * H * nv * nv * d

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the oracle is f32
    try:
        with torch.no_grad():
            one = torch.zeros((1,), device=device)
            rtt = time_call(lambda: one + 1.0, iters=args.iters)
            print(f"host RTT floor: {rtt * 1e3:.1f} ms", flush=True)
            oracle = None if args.no_oracle else f32_oracle(qkv, scale, nv)[:, :nv]

            results = []
            for name in args.variants:
                fn = _variant(name, qkv, scale, nv)
                if fn is None:
                    print(f"unknown variant {name}")
                    continue
                t = time_call(fn, iters=args.iters)
                tc = max(t - rtt, 1e-9)
                res = {"variant": name, "device": str(device), "raw_ms": t * 1e3,
                       "ms_less_rtt": tc * 1e3, "tflops": flops / tc / 1e12}
                msg = (f"{name:10s}: {t * 1e3:7.2f} ms raw | {tc * 1e3:7.2f} ms -RTT | "
                       f"{flops / tc / 1e12:6.1f} TF/s")
                if oracle is not None:
                    out = fn()[:, :nv].float()
                    err = (out - oracle).abs().max().item()
                    rel = err / max(oracle.abs().max().item(), 1e-9)
                    res.update(max_abs_err=err, rel_err=rel)
                    msg += f" | max-abs-err {err:.3e} (rel {rel:.3e})"
                    del out
                print(msg, flush=True)
                results.append(res)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return results


if __name__ == "__main__":
    main()
