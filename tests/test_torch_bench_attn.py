"""Parity of the port's attention bench (``midvision_probe_torch/
bench_attn.py``: K7 ``wide_attention``, K8 ``int8_attention``, K9
``splash_attention`` and ``main``) with the repository's JAX bench
(``launch_script/bench_attn.py``): on the CPU the port's wrappers run their
plain versions, held against the JAX Pallas kernels in interpret mode on the
same numpy inputs (JAX side under ``jax.default_matmul_precision("float32")``).

The JAX bench is loaded from its file. Importing it points JAX's persistent
compilation cache at a directory of its own for the whole process; the
fixture puts both cache settings back at once, so no test here or after it
in the same worker writes to that cache.

Tolerance: bf16, max abs error <= min(1.6e-2, 2^-6 * max|ref|): both sides
sum the same f32 scores in other orders and round p and the output to bf16,
which is a few bf16 ulps of the largest output (2^-6 of it is two to four
such ulps); the splash kernel also normalises after its PV product, not
before. The cap of 1.6e-2 binds only where |o| nears 1 (the clamp case)."""

import importlib.util
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch import bench_attn as t_bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = jax.default_matmul_precision("float32")
TOL = 1.6e-2  # the absolute cap
REL = 2.0**-6  # of the largest reference output
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def j_bench():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("_jax_bench_attn",
                                                  ROOT / "launch_script" / "bench_attn.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return module


def _jax_splash(qkv, scale, n_valid):
    """The JAX bench's ``splash_attention`` line for line, with the splash
    kernel in interpret mode (the bench's call runs only on a TPU)."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk,
    )
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_mask as sm,
    )

    B, N, _, H, d = qkv.shape
    q, k, v = jnp.moveaxis(qkv, 2, 0)
    q = (q.astype(jnp.float32) * scale).astype(qkv.dtype)
    q, k, v = (jnp.transpose(t, (0, 2, 1, 3)) for t in (q, k, v))
    valid = np.zeros((N, N), dtype=bool)
    valid[:, :n_valid] = True
    mask = sm.MultiHeadMask([sm.NumpyMask(valid)] * H)
    kernel = sk.make_splash_mha(mask, head_shards=1, q_seq_shards=1, interpret=True)
    out = jax.vmap(kernel)(q, k, v)
    return jnp.transpose(out, (0, 2, 1, 3)).reshape(B, N, H * d)


def _qkv(B, N, H, d, seed, clamp=False):
    """The bench's ``randn * 0.6``, or (clamp) q and k at std 5 (base-2
    scores far above 110) with v at std 0.25."""
    x = np.random.RandomState(seed).randn(B, N, 3, H, d).astype(np.float32)
    x *= np.array([5.0, 5.0, 0.25] if clamp else [0.6] * 3, np.float32)[:, None, None]
    return x


def _both(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, ref):
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=min(TOL, REL * np.abs(ref).max()))


B, N, H, D = 2, 256, 4, 64


@pytest.mark.parametrize("n_valid", [200, 256])
@pytest.mark.parametrize("width,stagger", [(128, False), (128, True), (256, False),
                                           (256, True)])
def test_wide_attention_matches_jax_kernel(j_bench, width, stagger, n_valid):
    x = _qkv(B, N, H, D, seed=n_valid + width)
    jq, tq = _both(x)
    with F32:
        ref = j_bench.wide_attention(jq, D**-0.5, n_valid, width=width, stagger=stagger,
                                     interpret=True)
    before = t_bench.wide_attention.launches
    _close(t_bench.wide_attention(tq, D**-0.5, n_valid, width=width, stagger=stagger), ref)
    assert t_bench.wide_attention.launches == before  # the plain version: no launch


@pytest.mark.parametrize("n_valid", [200, 256])
def test_int8_attention_matches_jax_kernel(j_bench, n_valid):
    jq, tq = _both(_qkv(B, N, H, D, seed=n_valid))
    with F32:
        ref = j_bench.int8_attention(jq, D**-0.5, n_valid, interpret=True)
    _close(t_bench.int8_attention(tq, D**-0.5, n_valid), ref)


@pytest.mark.parametrize("d", [16, 8])
def test_wide_attention_at_small_head_dims_matches_jax_kernel(j_bench, d):
    """Head dims that the JAX bench takes (``--hd``) and the port's card
    route instantiates at d rounded up to 16: d = 16 and 8, 8 heads, width
    4 * d."""
    jq, tq = _both(_qkv(1, 128, 8, d, seed=d))
    with F32:
        ref = j_bench.wide_attention(jq, d**-0.5, 120, width=4 * d, interpret=True)
    _close(t_bench.wide_attention(tq, d**-0.5, 120, width=4 * d), ref)


def test_int8_attention_at_head_dim_16_matches_jax_kernel(j_bench):
    """d = 16 with 8 heads at the JAX default width 128 (at d = 8 the JAX
    function itself fails: its reshape needs H * d to be a multiple of the
    width)."""
    jq, tq = _both(_qkv(1, 128, 8, 16, seed=16))
    with F32:
        ref = j_bench.int8_attention(jq, 0.25, 120, width=128, interpret=True)
    _close(t_bench.int8_attention(tq, 0.25, 120, width=128), ref)


@pytest.mark.parametrize("d", [8, 16, 64])
def test_int8_prologue_layout_on_the_cpu(d):
    """``quantize_qk_heads`` on the CPU: ``quantize_qk``'s q8 and k8
    head-major (B, H, N, dp), each row zero-padded to a multiple of 32
    bytes, and its c."""
    x = torch.from_numpy(_qkv(2, 40, 3, d, seed=d)).to(torch.bfloat16)
    q8, k8, c = t_bench.quantize_qk_heads(x, d**-0.5, 33)
    rq, rk, rc = t_bench.quantize_qk(x, d**-0.5, 33)
    dp = t_bench.int8_row_bytes(d)
    assert dp == max(32, d) and q8.shape == k8.shape == (2, 3, 40, dp)
    assert torch.equal(q8[..., :d], rq.transpose(1, 2))
    assert torch.equal(k8[..., :d], rk.transpose(1, 2))
    assert not q8[..., d:].any() and not k8[..., d:].any()
    assert torch.equal(c, rc)


@pytest.mark.parametrize("n_valid", [200, 256])
def test_splash_attention_matches_jax_kernel(n_valid):
    jq, tq = _both(_qkv(B, N, H, D, seed=n_valid + 1))
    with F32:
        ref = _jax_splash(jq, D**-0.5, n_valid)
    _close(t_bench.splash_attention(tq, D**-0.5, n_valid), ref)


def test_clamp_active_case_matches_jax_kernels(j_bench):
    """Base-2 scores above 110 (checked): ``min(s, 110)`` decides the
    output of K7 and K8; K9 (no clamp) and the f32 oracle too."""
    x = _qkv(B, N, H, D, seed=7, clamp=True)
    jq, tq = _both(x)
    n_valid, scale = 200, D**-0.5
    assert t_bench.wide_scores(tq, scale, n_valid).max() > 110
    assert t_bench.int8_scores(tq, scale, n_valid).max() > 110
    with F32:
        refs = [j_bench.wide_attention(jq, scale, n_valid, width=256, interpret=True),
                j_bench.int8_attention(jq, scale, n_valid, interpret=True),
                _jax_splash(jq, scale, n_valid)]
        oracle = j_bench.f32_oracle(jq, scale, n_valid)
    for fn, ref in zip((t_bench.wide_attention, t_bench.int8_attention,
                        t_bench.splash_attention), refs):
        _close(fn(tq, scale, n_valid), ref)
    np.testing.assert_allclose(t_bench.f32_oracle(tq, scale, n_valid).numpy(),
                               np.asarray(oracle), atol=1e-5, rtol=0)


@pytest.mark.parametrize("std", [0.6, 5.0])
def test_int8_quantization_equals_the_jax_expressions(std):
    """q8 and k8 bit for bit equal to the JAX bench's prologue
    (``int8_attention``'s lines, compiled by XLA); c within two f32 ulps
    (XLA folds scale * log2(e) / 127 into one constant)."""
    x = np.random.RandomState(11).randn(2, 256, 3, 4, 64).astype(np.float32) * std
    jq, tq = _both(x)
    n_valid, scale = 200, 0.125

    @jax.jit
    def prologue(qkv):
        q, k, _ = jnp.moveaxis(qkv, 2, 0)
        qa = jnp.max(jnp.abs(q[:, :n_valid].astype(jnp.float32)), axis=(0, 1, 3))
        ka = jnp.max(jnp.abs(k[:, :n_valid].astype(jnp.float32)), axis=(0, 1, 3))
        qs = jnp.maximum(qa, 1e-8) / 127.0
        ks = jnp.maximum(ka, 1e-8) / 127.0
        c = (scale * math.log2(math.e)) * qs * ks

        def quant(t, s):
            y = t.astype(jnp.float32) / s[None, None, :, None]
            return jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8)

        return quant(q, qs), quant(k, ks), c

    jq8, jk8, jc = prologue(jq)
    q8, k8, c = t_bench.quantize_qk(tq, scale, n_valid)
    assert q8.dtype == torch.int8 and q8.shape == (2, 256, 4, 64)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(k8.numpy(), np.asarray(jk8))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=2.4e-7, atol=0)


def test_main_on_the_cpu_prints_one_line_per_variant(capsys):
    variants = ["base", "wide2", "wide4", "stagger4", "int8", "splash"]
    results = t_bench.main(["--device", "cpu", "--batch", "2", "--n-valid", "200",
                            "--heads", "4", "--iters", "2", "--variants", *variants])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("host RTT floor:")
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == variants
    assert [r["variant"] for r in results] == variants
    for r, ln in zip(results, lines[1:]):
        assert "ms raw" in ln and "TF/s" in ln and "max-abs-err" in ln
        assert r["device"] == "cpu" and r["max_abs_err"] <= TOL and r["rel_err"] <= REL, r


def test_wrappers_reject_bad_arguments():
    qkv = torch.zeros(1, 128, 3, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="width"):
        t_bench.wide_attention(qkv, 0.1, 100, width=96)
    with pytest.raises(ValueError, match="n_valid"):
        t_bench.int8_attention(qkv, 0.1, 0)
    with pytest.raises(ValueError, match="qkv"):
        t_bench.splash_attention(qkv[:, :, 0], 0.1, 100)
