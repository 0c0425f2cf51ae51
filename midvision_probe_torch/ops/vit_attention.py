"""ViT softmax attention: the hand-written CUDA kernels K1 (fused qkv) and
K2 (``(B, H, N, d)`` operands), their plain PyTorch versions and the
wrappers that choose between them.

Counterpart of the JAX package's Pallas TPU kernels ``fused_qkv_attention``
(``ops/vit_attention.py``, ``_fused_forward`` -> ``_fused_kernel``) and
``vit_attention`` (``_forward`` -> ``_attn_kernel``). Both are
``csrc/vit_attention.cu``, with two entry points over three kernels (the
routes); its header says what bounds attention on an H100 (tensor-core
operations at the probing shapes) and what each route's design does about
it. The kernel picks the route by head dim and dtype and reports the one it
took; ``attention_route(d, dtype)`` mirrors that choice (for the checks made
before the device, and for reports that name the expected route):

* ``"wgmma"``: bf16 at d = 64 (DINO, CroCo-v2, the bench) and d = 80
  (RADIO-v2): warp-specialised, TMA-fed, ``wgmma`` products, 128 query
  rows a work item;
* ``"mma_sync"``: bf16 at d in {16, 32, 128}: the ``mma.sync`` kernel, 64
  query rows a block;
* ``"tf32x3"``: float32 at every head dim: each product split into
  ``hi + lo`` TF32 halves on the tensor cores (``hi*hi + hi*lo + lo*hi``,
  summed in f32), 112 query rows a block; a pre-pass splits k and v once
  into a scratch of (hi, lo) pairs (``2 * B*H*n_valid*d`` float pairs, which
  the wrapper allocates per call), read through a ``cp.async`` ring.

``kernel_takes(d, dtype)`` says whether any route takes a call at all (the
dispatch in ``ops/attention.py`` sends the others to einsum).
``route_launches`` counts the launches of each route, as the kernel reported
it.

* ``fused_qkv_attention(qkv, scale, n_valid=None)``: qkv ``(B, N, 3, H, d)``
  -> ``(B, N, H*d)``.
* ``vit_attention(q, k, v, scale)``: ``(B, H, N, d)`` each, any strides with
  a contiguous last dimension (q/k/v may be views of the qkv projection) ->
  ``(B, H, N, d)``, on a card a view of a ``(B, N, H, d)`` buffer so that the
  transpose back to tokens before ``proj`` is free.
* ``launch_attention(q, k, v, scale, n_valid=None, q_scale=1.0,
  return_lse=False)``: the strided launch behind ``vit_attention``, K3 and
  K9; ``q_scale`` multiplies q and rounds it to q's dtype before the scores
  (K9's ``bf16(q * scale)``); ``return_lse`` also returns each row's
  logsumexp, the residual of the backward.
* ``launch_attention_backward(q, k, v, out, lse, dout, scale, n_valid=None,
  q_scale=1.0)``: dq, dk and dv from ``csrc/attention_bwd.cu``, the
  backward of K3 (K10) and of K9 (K11), which the JAX package runs as the
  jax library's Pallas dq and dkv kernels: one pass per key tile, dq added
  atomically into an f32 accumulator and rounded by a finishing pass.
  ``backward_route(d, dtype)`` names its route (the forward's table: a
  ``wgmma`` + TMA kernel for bf16 at d 64/80, ``mma_sync`` for the other
  bf16 head dims, ``tf32x3`` for float32); ``backward_route_launches``
  counts its launches by the route the kernel reported.
* For a CPU tensor each runs its plain version; for a CUDA tensor it
  launches the kernel or raises. There is no fallback.
* Gradients follow the JAX package's ``custom_vjp``s: K1 and K2 take the
  vjp of their plain version, recomputed (``_fused_bwd`` and ``_bwd`` take
  the vjp of ``_fused_einsum_ref`` and ``_einsum_ref``); K3 and K9 take
  K10 and K11 (``ops/attention.py``, ``bench_attn.py``).
* ``_fused_qkv_attention_plain`` / ``_vit_attention_plain``: the einsum +
  softmax formulations of the JAX package's ``_fused_einsum_ref`` /
  ``_einsum_ref`` (``q * scale`` in the input dtype, f32 scores and softmax,
  probabilities cast to the input dtype before the PV product).

Constraints of the CUDA kernels (they replace the TPU-only gates of the JAX
package: 128-lane divisibility, the VMEM cap, N >= 256 and the 128-padding
do not apply): head dim d in {16, 32, 64, 80, 128}; K1 keeps the JAX fused
kernel's d | 128 (so a model takes the same branch as on the TPU); dtype
bfloat16 or float32; 16-byte aligned rows; any N >= 1 (1 <= n_valid <= N).
A frozen call (no input that requires grad, or grad mode off) launches the
kernel alone and records nothing.
"""

from __future__ import annotations

import ctypes
import math
import numbers

import torch

from midvision_probe_torch.ops.cuda_build import float_bits, load_library

_LOG2E = math.log2(math.e)
_HEAD_DIMS = (16, 32, 64, 80, 128)  # the kernels'
FUSED_HEAD_DIMS = (16, 32, 64, 128)  # K1: the JAX fused kernel's d | 128
WGMMA_HEAD_DIMS = (64, 80)  # bf16 head dims on the wgmma route
_DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("wgmma", "mma_sync", "tf32x3")  # by the route code the C entry points report
route_launches = dict.fromkeys(ROUTES, 0)  # kernel launches by route
# the attention backward's launches (K10, K11) by route, as its C entry reports
backward_route_launches = dict.fromkeys(ROUTES, 0)
_BWD_PAD_ROWS = 64  # the backward's lse and di rows are padded to a multiple of this


def kernel_takes(d: int, dtype: torch.dtype) -> bool:
    """Whether a route of the attention kernel takes head dim ``d`` in
    ``dtype`` (the table ``attention_route`` reads)."""
    return d in _HEAD_DIMS and dtype in _DTYPES


def attention_route(d: int, dtype: torch.dtype) -> str:
    """The kernel that runs attention at head dim ``d`` in ``dtype`` on a
    card: ``"wgmma"`` (bf16, d in ``WGMMA_HEAD_DIMS``), ``"mma_sync"``
    (bf16, other head dims) or ``"tf32x3"`` (float32), as
    ``csrc/vit_attention.cu``'s ``route_of`` chooses. Raises on what no
    kernel takes."""
    if not kernel_takes(d, dtype):
        if d not in _HEAD_DIMS:
            raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma_sync"


def _fused_qkv_attention_plain(qkv: torch.Tensor, scale: float,
                               n_valid: int | None = None) -> torch.Tensor:
    """Einsum formulation with the kernel's semantics: every query row
    (padded rows included) attends over the first ``n_valid`` keys/values
    only."""
    B, N, _, H, d = qkv.shape
    q, k, v = qkv.unbind(2)  # each (B, N, H, d)
    if n_valid is not None:
        k, v = k[:, :n_valid], v[:, :n_valid]
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, H * d)


def _vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """(B, H, N, d) einsum formulation (the JAX package's ``_einsum_ref``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _kernel():
    lib = load_library("vit_attention")
    fn = lib.mvp_fused_qkv_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _strided_kernel():
    fn = load_library("vit_attention").mvp_vit_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_int64] * 12 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _pairs(B: int, H: int, n_valid: int, d: int, dtype: torch.dtype, device):
    """The tf32x3 route's scratch: the (hi, lo) TF32 pairs of k and v, which
    its pre-pass writes once per call (None for bf16)."""
    if dtype != torch.float32:
        return None
    return torch.empty((2, B, H, n_valid, d, 2), dtype=dtype, device=device)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Recomputed(torch.autograd.Function):
    """Forward: a kernel launch; backward: the vjp of the plain version
    ``plain``, recomputed from the saved inputs, as the JAX package's
    ``custom_vjp``s of K1 and K2 take the vjp of their einsum reference."""

    @staticmethod
    def forward(ctx, launch, plain, args, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain, ctx.args = plain, args
        return launch(*inputs, *args)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*inputs, *ctx.args)
            grads = torch.autograd.grad(out, inputs, grad)
        return (None, None, None, *grads)


def fused_qkv_attention(qkv: torch.Tensor, scale: float,
                        n_valid: int | None = None) -> torch.Tensor:
    """Non-causal attention on the fused projection output.

    qkv ``(B, N, 3, H, d)`` -> ``(B, N, H*d)``. ``n_valid``: rows >= n_valid
    are padding; their keys/values are excluded (never read by the kernel)
    and their output rows attend over the valid keys like any other row.
    Differentiable: the gradient is the plain version's (F12)."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, d), got {tuple(qkv.shape)}")
    B, N, _, H, d = qkv.shape
    if n_valid is not None and not 0 < n_valid <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if qkv.device.type == "cpu":
        return _fused_qkv_attention_plain(qkv, scale, n_valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if d not in FUSED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FUSED_HEAD_DIMS}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"dtype {qkv.dtype} not in {_DTYPES}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if _needs_grad(qkv):
        return _Recomputed.apply(_launch_fused, _fused_qkv_attention_plain, (scale, n_valid),
                                 qkv)
    return _launch_fused(qkv, scale, n_valid)


def _launch_fused(qkv: torch.Tensor, scale: float, n_valid: int | None) -> torch.Tensor:
    """K1's launch on a checked CUDA qkv, counted."""
    B, N, _, H, d = qkv.shape
    out = torch.empty((B, N, H * d), dtype=qkv.dtype, device=qkv.device)
    nv = N if n_valid is None else n_valid
    pairs = _pairs(B, H, nv, d, qkv.dtype, qkv.device)
    ran = ctypes.c_int(-1)
    with torch.cuda.device(qkv.device):
        err = _kernel()(
            qkv.data_ptr(), out.data_ptr(), None if pairs is None else pairs.data_ptr(),
            B, N, H, d,
            N if n_valid is None else n_valid, float_bits(scale * _LOG2E),
            int(qkv.dtype == torch.bfloat16), ctypes.byref(ran),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qkv_attention kernel launch failed: "
                           f"cudaError {err}")
    fused_qkv_attention.launches += 1
    route_launches[ROUTES[ran.value]] += 1
    return out


fused_qkv_attention.launches = 0  # kernel launches (never the plain twin)


def _rows_aligned(t: torch.Tensor) -> bool:
    """A 16-byte aligned start for every (b, h, n) row."""
    size = t.element_size()
    return not (t.data_ptr() % 16 or any(st * size % 16 for st, n in
                                         zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The kernel reads every row with 16-byte copies: unit last stride and
    a 16-byte aligned start for every (b, h, n) row."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension")
    if not _rows_aligned(t):
        raise ValueError(f"{name} rows must be 16-byte aligned")


def _check_operands(q, k, v, n_valid, q_scale):
    """The checks of the strided launches, before the device: (B, H, N, d)
    of one shape and dtype that a route takes, ``n_valid`` in [1, N], a
    finite ``q_scale``. Returns n_valid (default N)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must be (B, H, N, d) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N = q.shape[2]
    n_valid = N if n_valid is None else n_valid
    if not 0 < n_valid <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if not isinstance(q_scale, numbers.Real) or not math.isfinite(q_scale):
        raise ValueError(f"q_scale must be a finite float, got {q_scale!r}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: q, k, v must share one")
    attention_route(q.shape[-1], q.dtype)  # raises on a head dim or dtype no kernel takes
    return n_valid


def _check_card(tensors: dict) -> None:
    """Every tensor on one card, with rows the kernels read."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    if any(t.device != first.device for t in tensors.values()):
        raise ValueError(f"{', '.join(tensors)} must be on one device")
    for name, t in tensors.items():
        _check_rows(name, t)


def _token_major(B: int, H: int, N: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """The (B, H, N, d) view of a fresh (B, N, H, d) buffer, so that the
    transpose back to tokens is free."""
    return torch.empty((B, N, H, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, n_valid: int | None = None,
                     q_scale: float = 1.0, return_lse: bool = False):
    """Launch the strided kernel on CUDA ``(B, H, N, d)`` operands; returns
    the ``(B, H, N, d)`` view of a fresh ``(B, N, H, d)`` buffer and, with
    ``return_lse``, each row's natural logsumexp of its scores, f32
    ``(B, H, N)`` (the backward's residual; a frozen launch asks for none).
    Keys and values at index >= ``n_valid`` (default N) are excluded and
    never read. ``q_scale`` (a finite float): q enters the scores as
    ``q * q_scale`` rounded to q's dtype (K9 passes its softmax scale here
    and ``scale`` 1). Raises on anything the kernel does not take; the
    arguments are checked before the device. Not differentiable itself: the
    callers (``vit_attention``, ``ops.attention._flash_attention`` and
    ``bench_attn.splash_attention``) wrap it in their gradients and count
    the launch; ``route_launches`` counts it by route."""
    n_valid = _check_operands(q, k, v, n_valid, q_scale)
    if _needs_grad(q, k, v):
        raise RuntimeError("launch_attention records no gradient; call vit_attention, "
                           "ops.attention._flash_attention or bench_attn.splash_attention")
    _check_card({"q": q, "k": k, "v": v})
    B, H, N, d = q.shape
    out = _token_major(B, H, N, d, q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if return_lse else None
    pairs = _pairs(B, H, n_valid, d, q.dtype, q.device)
    ran = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = _strided_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if pairs is None else pairs.data_ptr(),
            None if lse is None else lse.data_ptr(), B, N, H, d, n_valid,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float_bits(scale * _LOG2E), float_bits(float(q_scale)),
            int(q.dtype == torch.bfloat16), ctypes.byref(ran),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    route_launches[ROUTES[ran.value]] += 1
    return (out, lse) if return_lse else out


def backward_route(d: int, dtype: torch.dtype) -> str:
    """The kernel that runs the attention backward (K10, K11) at head dim
    ``d`` in ``dtype`` on a card, as ``csrc/attention_bwd.cu``'s
    ``route_of`` chooses: the forward's table (``attention_route``), each
    route a one-pass design of its own. Raises on what no kernel takes."""
    return attention_route(d, dtype)


def _backward_kernel():
    fn = load_library("attention_bwd").mvp_attention_backward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              scale: float, n_valid: int | None = None,
                              q_scale: float = 1.0):
    """The backward of ``launch_attention`` on a card (K10 for K3, K11 for
    K9; ``csrc/attention_bwd.cu``): ``(dq, dk, dv)``, each the (B, H, N, d)
    view of a fresh (B, N, H, d) buffer, from the forward's operands, its
    output ``out`` and ``lse`` (``return_lse``) and the output's gradient
    ``dout``. A prologue pass computes ``di = rowsum(dout * out)`` in f32
    outside the main kernel, as the jax library computes it, into a
    zero-padded f32 buffer with lse (rows of a multiple of 64, which the
    kernels copy whole). The kernel adds dq into a zeroed f32 accumulator
    (atomics: dq is not bit-reproducible between runs) and a finishing pass
    rounds it. With ``q_scale`` the kernel sees ``q' = q * q_scale`` rounded
    to q's dtype (the prologue writes it to a scratch), as the forward did,
    and dq is ``dq' * q_scale`` rounded to q's dtype (the multiplication's
    transpose, after dq' is rounded). dk and dv are 0 at keys >=
    ``n_valid``. float32 also takes a scratch for the (hi, lo) TF32 pairs of
    q, k, v and dout. Every buffer is allocated here; the kernel allocates
    nothing. Raises on anything the kernel does not take, before the device;
    a refused launch raises, with nothing to fall back to.
    ``backward_route_launches`` counts the launch by the route the kernel
    reports; the callers count it too."""
    n_valid = _check_operands(q, k, v, n_valid, q_scale)
    B, H, N, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype}, got {out.dtype}, {dout.dtype}")
    if (lse.shape != (B, H, N) or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(B, H, N)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if dout.stride(-1) != 1 or not _rows_aligned(dout):
        dout = dout.contiguous()  # autograd's gradient may come in any layout
    _check_card({"q": q, "k": k, "v": v, "out": out, "dout": dout})
    if lse.device != q.device:
        raise ValueError("lse must be on q's device")
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.zeros((2, B, H, -(-N // _BWD_PAD_ROWS) * _BWD_PAD_ROWS), **f32)
    qs = torch.empty_like(q, memory_format=torch.contiguous_format) if q_scale != 1.0 else None
    pairs = (torch.empty(((2 * N + 2 * n_valid) * B * H * d, 2), **f32)
             if q.dtype == torch.float32 else None)
    dq_acc = torch.zeros((B, H, N, d), **f32)
    dq, dk, dv = (_token_major(B, H, N, d, q) for _ in range(3))
    strides = (ctypes.c_longlong * 24)(*(st for t in (q, k, v, dout, dq, dk, dv, out)
                                         for st in t.stride()[:3]))
    ran = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = _backward_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), stats.data_ptr(), None if qs is None else qs.data_ptr(),
            None if pairs is None else pairs.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, B, N, H, d, n_valid, float_bits(scale),
            float_bits(float(q_scale)), int(q.dtype == torch.bfloat16), ctypes.byref(ran),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    backward_route_launches[ROUTES[ran.value]] += 1
    return dq, dk, dv


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Non-causal, unmasked attention on ``(B, H, N, d)`` operands.
    Differentiable: the gradient is the plain version's (F12)."""
    if q.device.type == "cpu":
        return _vit_attention_plain(q, k, v, scale)
    if _needs_grad(q, k, v):
        out = _Recomputed.apply(launch_attention, _vit_attention_plain, (scale,), q, k, v)
    else:
        out = launch_attention(q, k, v, scale)
    vit_attention.launches += 1
    return out


vit_attention.launches = 0  # kernel launches (never the plain version)
