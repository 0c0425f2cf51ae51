"""The port's headline bench (``midvision_probe_torch/bench.py``) against the
repository's root ``bench.py``.

* The timed forward: ``bench.forward`` (the dense 4-tap bf16 maps cast to
  float32 and the checksum ``sum(maps[-1][0, 0, 0])``) on test_tiny_vit at
  32x48, batch 2, with the JAX extractor's weights carried across by
  ``convert/from_jax.py``, against the JAX bench's jitted forward
  (``bench.py:92-99``: ``_apply_fn``, f32 cast, checksum) on the same numpy
  images, the JAX side under ``jax.default_matmul_precision("float32")``.
  Tolerance: the bf16 bound of the ViT bf16 parity tests
  (``tests/test_torch_time_suite.py``), every map within 2^-6 * max|map|
  (the two sides round to bf16 at other points, an ulp apart on most
  values); the checksum, a sum over the last map's C channels at one
  pixel, within C * 2^-6 * max|map|.
* ``main(["--device", "cpu"])`` with the image size and iteration count
  shrunk through the module constants: one JSON line with the JAX keys,
  both metric names, ``$MVP_BENCH_BATCH`` and ``vs_baseline``.
* The pre-flight (a failed card probe exits 2 with the reason on stderr,
  before anything is built) and a host without a card (it raises).

Torch runs on one thread, restored after.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch import bench as t_bench
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
JAX_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py:121-130
TINY = "test_tiny_vit"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_forward(images: np.ndarray):
    """The root bench's forward, line for line, on test_tiny_vit; returns its
    maps, checksum and weights."""
    backbone = j_zoo.build_vit_extractor(TINY, output="dense", return_multilayer=True,
                                         dtype=jnp.bfloat16, init_size=224)
    bb_vars = backbone.device_variables

    @jax.jit
    def forward(variables, images):
        maps, _ = backbone._apply_fn(variables, images)
        maps = [m.astype(jnp.float32) for m in maps]
        return maps, jnp.sum(maps[-1][0, 0, 0])

    with F32:
        maps, chk = forward(bb_vars, jnp.asarray(images))
    return ([np.asarray(m) for m in maps], float(chk),
            jax.tree_util.tree_map(np.asarray, bb_vars))


def test_timed_forward_matches_the_jax_bench():
    images = np.random.RandomState(0).randn(2, 32, 48, 3).astype(np.float32)
    ref_maps, ref_chk, variables = _jax_forward(images)
    backbone = t_bench.build_backbone(TINY, "cpu")
    assert next(backbone.module.parameters()).dtype == torch.bfloat16
    backbone.module.load_state_dict(vit_state_dict(variables))
    maps, chk = t_bench.forward(backbone, torch.from_numpy(images))
    assert len(maps) == len(ref_maps) == 4
    for got, ref in zip(maps, ref_maps):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 4, 6, 32)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2**-6 * np.abs(ref).max())
    C = ref_maps[-1].shape[-1]
    assert float(chk) == pytest.approx(float(maps[-1][0, 0, 0].sum()))
    assert abs(float(chk) - ref_chk) <= C * 2**-6 * np.abs(ref_maps[-1]).max()


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench at 32x48 and 2 timed calls, every forward's batch recorded,
    and every zoo name it asks for built as test_tiny_vit (recorded)."""
    monkeypatch.setattr(t_bench, "IMAGE_HW", (32, 48))
    monkeypatch.setattr(t_bench, "N_ITERS", 2)
    seen = {"names": [], "batches": []}
    build, forward = t_bench.zoo.build_vit_extractor, t_bench.forward

    def tiny_build(name, **kw):
        seen["names"].append(name)
        return build(TINY, **kw)

    def recorded_forward(backbone, images):
        seen["batches"].append(images.shape[0])
        return forward(backbone, images)

    monkeypatch.setattr(t_bench.zoo, "build_vit_extractor", tiny_build)
    monkeypatch.setattr(t_bench, "forward", recorded_forward)
    return seen


def _one_line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("backbone,batch,metric", [
    (None, None, "vitb16_dense_multilayer_imgs_per_sec_per_chip"),
    ("mae_vitb16", "3", "mae_vitb16_dense_multilayer_imgs_per_sec_per_chip"),
])
def test_main_prints_one_json_line_with_the_jax_keys(tiny_bench, monkeypatch, capsys,
                                                     backbone, batch, metric):
    for var, value in (("MVP_BENCH_BACKBONE", backbone), ("MVP_BENCH_BATCH", batch)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    ret = t_bench.main(["--device", "cpu"])
    line = _one_line(capsys)
    assert line == ret and list(line) == JAX_KEYS
    assert line["metric"] == metric and line["unit"] == "imgs/sec/chip"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 250, 3)
    assert tiny_bench["names"] == [backbone or "dino_vitb16"]
    # one warm-up call and N_ITERS timed ones, at the batch asked for
    assert tiny_bench["batches"] == [int(batch or 64)] * 3


def test_a_backbone_outside_the_vit_zoo_is_refused_by_name():
    with pytest.raises(ValueError, match="not a ViT of the zoo.*'dino_vitb16'"):
        t_bench.build_backbone("sam_vit_b", "cpu")


def test_a_failed_preflight_exits_2_with_the_reason(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(t_bench, "probe_backend",
                        lambda: (False, "the card probe did not answer within 120 s"))

    def no_build(*args, **kwargs):
        raise AssertionError("built a backbone after a failed pre-flight")

    monkeypatch.setattr(t_bench.zoo, "build_vit_extractor", no_build)
    with pytest.raises(SystemExit) as e:
        t_bench.main([])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "bench preflight: the card probe did not answer within 120 s" in out.err


def test_without_a_card_it_raises_and_does_not_run_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_probe(*args, **kwargs):
        raise AssertionError("probed a card that is not there")

    monkeypatch.setattr(t_bench, "probe_backend", no_probe)
    monkeypatch.setattr(t_bench, "run", no_probe)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_bench.main([])
