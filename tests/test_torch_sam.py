"""The SAM image encoder in the PyTorch port against the JAX package's:

* ``_get_rel_pos`` with and without the linear resize of its table, in
  float32 (within 1e-6) and bfloat16 (the table cast first, as the JAX
  ``SAMAttention`` does; within one bf16 ulp);
* window partition and unpartition at a grid that needs padding: equal to
  the JAX functions', the padding zeros, the round trip exact;
* a narrow ``SAMViT`` (width 64, depth 4, 4 heads, window 4, global blocks
  1 and 3, ``table_grid`` (8, 8)) at 80x112 (a 5x7 grid: neither a window
  multiple nor the table grid), random weights (relative-position tables
  and pos-embed included) carried across by ``convert.from_jax.
  sam_state_dict``: the taps within 1e-5 * max|ref| in float32 and within
  2^-5 * max|ref| in bfloat16 (over four seeds at most 1.2e-2 * max|ref|;
  a control with the relative-position bias built in f32 read the same, as
  the rounding of every layer hides it);
* so the bias alone, in a global ``SAMAttention`` at a 4x4 grid (its
  tables resized from the 8x8 grid's) whose scores are the bias alone
  (k = 0) and whose output is the bf16 softmax itself (one-hot tokens, v
  selecting them, an identity ``proj``): over five seeds at most 9.8e-4
  of the outputs differ, by at most 2.7e-4 * max|ref|; the control with
  the bias in f32 differs in 40-45% of them, by 3.3e-3 to 4.9e-3 *
  max|ref|. The limits, 1e-2 of the outputs and 2^-10 * max|ref|, lie
  between;
* the converter on a segment_anything container (``image_encoder.*`` with
  the neck, ``prompt_encoder.*`` and ``mask_decoder.*`` junk): the JAX
  converter's tree exactly; both zoos load the file (the preset narrowed in
  both packages) to taps within 1e-5 * max|ref|, and the port never
  random-initialises;
* the ``SAM`` constructor's contract: ``feat_dim`` and the n/4 taps of
  ViT-B and ViT-L, f32 maps at the /16 grid.

The JAX side runs under ``jax.default_matmul_precision("float32")``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import sam_state_dict
from midvision_probe_torch.models import vit_sam as t_sam
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.models.convert import convert_sam as t_convert
from midvision_probe_tpu.models import vit_sam as j_sam
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.models.convert.sam_convert import convert_sam as j_convert

F32 = jax.default_matmul_precision("float32")
NARROW = dict(width=64, depth=4, num_heads=4, window_size=4, global_attn_indexes=(1, 3),
              mlp_ratio=2.0, table_grid=(8, 8))


def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda x: (0.1 * rng.randn(*np.shape(x))).astype(np.float32), tree)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_close(got, ref, rel):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("size,table", [(4, 7), (5, 15), (7, 15), (30, 127)],
                         ids=["window", "resize_5", "resize_7", "global_30"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_get_rel_pos_matches_jax(rng, size, table, dtype):
    rel = rng.randn(table, 16).astype(np.float32)
    ref = np.asarray(j_sam._get_rel_pos(size, size, jnp.asarray(rel).astype(dtype))
                     .astype(jnp.float32))
    got = t_sam._get_rel_pos(size, size, torch.from_numpy(rel).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (size, size, 16)
    tol = 1e-6 if dtype == "float32" else 2**-8
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)
    if 2 * size - 1 == table:  # no resize: a pure gather of the table
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_window_partition_roundtrip_matches_jax(rng):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    jw, jhp = j_sam._window_partition(jnp.asarray(x), 4)
    tw, thp = t_sam._window_partition(torch.from_numpy(x), 4)
    assert thp == tuple(jhp) == (8, 8)
    assert tuple(tw.shape) == (8, 4, 4, 3)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert float(tw[1, :, 3:].abs().max()) == 0.0  # the padded column of window 1
    back = t_sam._window_unpartition(tw, 4, thp, (5, 7))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_sam._window_unpartition(jw, 4, jhp, (5, 7))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_sam_vit_taps_match_jax(rng, dtype):
    images = rng.randn(2, 80, 112, 3).astype(np.float32)
    taps = (0, 1, 2, 3)
    jmod = j_sam.SAMViT(j_sam.SAMViTConfig(dtype=getattr(jnp, dtype), **NARROW))
    variables = _random_like(
        jax.jit(lambda k, x: jmod.init(k, x, taps=taps))(jax.random.PRNGKey(0),
                                                         jnp.asarray(images)), rng)
    with F32:
        ref = jax.jit(lambda v, x: jmod.apply(v, x, taps=taps))(variables,
                                                                 jnp.asarray(images))
    tmod = t_sam.SAMViT(t_sam.SAMViTConfig(**NARROW))
    tmod.load_state_dict(sam_state_dict(variables), strict=True)
    tmod = t_zoo._cast(tmod, "cpu", dtype, keep_f32=t_sam.KEEP_F32)
    assert tmod.pos_embed.dtype == torch.float32
    assert tuple(tmod.blocks[1].attn.rel_pos_h.shape) == (15, 16)  # the table grid's
    assert tuple(tmod.blocks[0].attn.rel_pos_h.shape) == (7, 16)  # a window's
    with torch.no_grad():
        res = tmod(torch.from_numpy(images), taps=taps)
    assert res["grid_hw"] == (5, 7)
    for g, r in zip(res["maps"], ref["maps"]):
        assert tuple(g.shape) == (2, 5, 7, 64) and g.dtype == getattr(torch, dtype)
        _assert_close(g.float().numpy(), r, 1e-5 if dtype == "float32" else 2**-5)
    with torch.no_grad():  # blocks past the last tap do not change a tap
        first = tmod(torch.from_numpy(images), taps=(1,))["maps"][0]
    np.testing.assert_array_equal(first.float().numpy(), res["maps"][1].float().numpy())


def sam_container(width, depth, heads, global_idx, window=14, grid=64, mlp_ratio=4, seed=0):
    """A segment_anything ``sam_vit_*.pth`` in its own naming: the image
    encoder (neck included) under ``image_encoder.``, and prompt-encoder and
    mask-decoder junk; random weights."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    hd, hidden = width // heads, mlp_ratio * width
    sd = {"image_encoder.pos_embed": r(1, grid, grid, width),
          "image_encoder.patch_embed.proj.weight": r(width, 3, 16, 16),
          "image_encoder.patch_embed.proj.bias": r(width)}
    for i in range(depth):
        b = f"image_encoder.blocks.{i}"
        t = grid if i in global_idx else window
        sd.update({f"{b}.norm1.weight": 1 + r(width), f"{b}.norm1.bias": r(width),
                   f"{b}.attn.rel_pos_h": r(2 * t - 1, hd),
                   f"{b}.attn.rel_pos_w": r(2 * t - 1, hd),
                   f"{b}.attn.qkv.weight": r(3 * width, width), f"{b}.attn.qkv.bias": r(3 * width),
                   f"{b}.attn.proj.weight": r(width, width), f"{b}.attn.proj.bias": r(width),
                   f"{b}.norm2.weight": 1 + r(width), f"{b}.norm2.bias": r(width),
                   f"{b}.mlp.lin1.weight": r(hidden, width), f"{b}.mlp.lin1.bias": r(hidden),
                   f"{b}.mlp.lin2.weight": r(width, hidden), f"{b}.mlp.lin2.bias": r(width)})
    sd.update({"image_encoder.neck.0.weight": r(16, width, 1, 1),
               "image_encoder.neck.1.weight": r(16), "image_encoder.neck.1.bias": r(16),
               "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": r(2, 8),
               "mask_decoder.iou_token.weight": r(1, 16)})
    return sd


def test_rel_pos_bias_is_built_in_the_compute_dtype(rng):
    g, width, nh = 4, 64, 4
    hd, n = width // nh, g * g
    x = np.zeros((2, g, g, width), np.float32)
    x.reshape(2, n, width)[:, np.arange(n), np.arange(n)] = 1.0  # token t: e_t
    kernel = np.zeros((width, 3 * width), np.float32)  # (in, out): q | k = 0 | v
    kernel[:, :width] = 0.5 * rng.randn(width, width)
    for head in range(nh):
        kernel[np.arange(hd), 2 * width + head * hd + np.arange(hd)] = 1.0
    params = {"qkv": {"kernel": kernel, "bias": np.zeros(3 * width, np.float32)},
              "proj": {"kernel": np.eye(width, dtype=np.float32),
                       "bias": np.zeros(width, np.float32)},
              "rel_pos_h": (0.5 * rng.randn(15, hd)).astype(np.float32),
              "rel_pos_w": (0.5 * rng.randn(15, hd)).astype(np.float32)}
    cfg = dict(width=width, depth=2, num_heads=nh, window_size=4, global_attn_indexes=(1,),
               table_grid=(8, 8))
    jattn = j_sam.SAMAttention(j_sam.SAMViTConfig(dtype=jnp.bfloat16, **cfg),
                               use_rel_pos=True, table_hw=(8, 8))
    with F32:
        ref = np.asarray(jattn.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)),
                         np.float32)
    tattn = t_sam.SAMAttention(t_sam.SAMViTConfig(**cfg), (8, 8))
    sd = {"qkv.weight": kernel.T, "qkv.bias": params["qkv"]["bias"],
          "proj.weight": params["proj"]["kernel"].T, "proj.bias": params["proj"]["bias"],
          "rel_pos_h": params["rel_pos_h"], "rel_pos_w": params["rel_pos_w"]}
    tattn.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    tattn = t_zoo._cast(tattn, "cpu", "bfloat16", keep_f32=t_sam.KEEP_F32)
    with torch.no_grad():
        got = tattn(torch.from_numpy(x).bfloat16()).float().numpy()
    assert got.shape == ref.shape == (2, g, g, width)
    np.testing.assert_allclose(ref.reshape(2, n, nh, hd).sum(-1), 1.0, atol=0.05)  # softmax rows
    assert (got != ref).mean() <= 1e-2
    assert np.abs(got - ref).max() <= 2**-10 * np.abs(ref).max()


def test_converter_gives_the_jax_tree():
    sd = sam_container(64, 4, 4, (1, 3), window=4, grid=8, mlp_ratio=2, seed=1)
    tcfg, jcfg = t_sam.SAMViTConfig(**NARROW), j_sam.SAMViTConfig(**NARROW)
    tree, ref = t_convert(sd, tcfg), j_convert(sd, jcfg)
    g, r = dict(_flat(tree)), dict(_flat(ref))
    assert g.keys() == r.keys()
    for k in r:
        assert g[k].dtype == r[k].dtype
        np.testing.assert_array_equal(g[k], r[k], err_msg=str(k))
    t_sam.SAMViT(tcfg).load_state_dict(sam_state_dict(tree), strict=True)


SAM_NARROW_PRESET = dict(width=32, depth=4, num_heads=2, global_attn_indexes=(1, 3))


def test_both_zoos_load_the_file_to_one_feature(tmp_path, monkeypatch, rng):
    for mod in (t_sam, j_sam):
        monkeypatch.setitem(mod.SAM_PRESETS, "vit_b", SAM_NARROW_PRESET)
    torch.save(sam_container(32, 4, 2, (1, 3), seed=2),
               tmp_path / t_zoo.ZOO["sam_vit_b"].filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    text = t_zoo.SAM(arch="vit_b", return_multilayer=True, device="cpu")
    jext = j_zoo.SAM(arch="vit_b", return_multilayer=True)
    assert dataclasses.asdict(text.spec) == dataclasses.asdict(jext.spec)
    images = rng.randn(1, 64, 80, 3).astype(np.float32)
    got = text(torch.from_numpy(images))
    with F32:
        ref = jext(jnp.asarray(images))
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (1, 4, 5, 32) and g.dtype == torch.float32
        _assert_close(g.numpy(), r, 1e-5)


def test_sam_presets_are_the_jax_ones():
    assert t_sam.SAM_PRESETS == j_sam.SAM_PRESETS
    assert dataclasses.asdict(t_sam.SAMViTConfig()) == {
        k: v for k, v in dataclasses.asdict(j_sam.SAMViTConfig()).items() if k != "dtype"}


@pytest.mark.parametrize("arch", ["vit_b", "vit_l"])
def test_sam_ctor_contract(monkeypatch, rng, arch):
    """Each preset's depth and global blocks at width 32: ``feat_dim`` is the
    width, the taps are the n/4 schedule (ViT-B 2, 5, 8, 11; ViT-L 5, 11, 17,
    23), the maps float32 at the /16 grid."""
    preset = dict(t_sam.SAM_PRESETS[arch], width=32, num_heads=2)
    monkeypatch.setitem(t_sam.SAM_PRESETS, arch, preset)
    taps = {"vit_b": [2, 5, 8, 11], "vit_l": [5, 11, 17, 23]}[arch]
    m = t_zoo.SAM(arch=arch, output="dense", return_multilayer=True, device="cpu")
    assert m.feat_dim == [32] * 4 and m.multilayers == taps
    assert m.arch == "sam" and m.patch_size == 16 and m.checkpoint_name == f"sam_{arch}"
    outs = m(torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32)))
    assert [tuple(o.shape) for o in outs] == [(1, 4, 4, 32)] * 4
    assert all(o.dtype == torch.float32 for o in outs)
    last = t_zoo.SAM(arch=arch, output="gap", device="cpu")
    assert last.feat_dim == 32 and last.multilayers == taps[-1:]
    assert tuple(last(torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32))).shape) \
        == (1, 32)
