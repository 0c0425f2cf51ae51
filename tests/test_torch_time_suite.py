"""The port's suite-timing tool (``midvision_probe_torch/launch/time_suite.py``)
against the repository's ``launch_script/time_suite.py``.

* The steps: the JAX script's ``measure_backbone`` runs on test_tiny_vit at
  32², batch 2, the DPT probe (32 hidden channels) in float32, with its
  ``timeit`` replaced by a recorder, so its jitted ``probe_step`` and
  ``full_step`` and their arguments are captured without a clock (the
  script itself is not edited). The port's ``build_steps`` takes the same
  seeded inputs and the JAX backbone, tap-norm and probe weights
  (``convert/from_jax.py``). Its probe step on the JAX features and its
  full step with the extractor fed the JAX bf16 taps: the loss within
  1e-5 relative; the gradients within 5% of each tensor's max|g| of the
  JAX step's (read from its AdamW first moment, mu = (1 - β1)·g after one
  step); the updated tap-norm and probe parameters within 1e-5·max|ref|
  of each tensor where the JAX gradient is above 5% of its tensor's max,
  and within a sign flip of AdamW's first update (2·lr) elsewhere: that
  update is lr·sign(g), and the gradients of this step move by up to 11%
  of max|g| under a reordered sum (``tests/test_torch_graft_entry.py``).
  The full step with the port's own bf16 extraction: its taps within
  2^-6·max|tap| of the JAX ones and the loss within 1e-4 relative.
* The projection: both scripts' ``main`` with the same three times per
  backbone and variant: every number of the report equal, variant row by
  variant row, with the JAX "v4-8" line read as ``--cards 4``.

The JAX side runs under ``jax.default_matmul_precision("float32")``; the
port on one torch thread, restored after.
"""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.launch import time_suite

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = jax.default_matmul_precision("float32")
LR = 5e-4
B1 = 0.9  # optax.adamw's first-moment decay
SURE_GRAD = 0.05


def _jax_time_suite():
    """``launch_script/time_suite.py`` under a module name of its own; its
    import-time compile-cache settings are put back after."""
    saved = {k: getattr(jax.config, k) for k in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location("jax_launch_time_suite",
                                                  ROOT / "launch_script" / "time_suite.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


J_TS = _jax_time_suite()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_steps():
    calls = []

    def record(fn, *args, iters=10):
        calls.append((fn, args))
        return 1e-3

    orig = J_TS.timeit
    J_TS.timeit = record
    try:
        with F32:
            J_TS.measure_backbone("test_tiny_vit", 2, hw=(32, 32), head_type="dpt",
                                  probe_dtype=jnp.float32, hidden_dim=32)
    finally:
        J_TS.timeit = orig
    (extract, (images,)), (probe_l, probe_args), (full_l, full_args) = calls
    params, stats, opt_state, feats, depth = probe_args
    with F32:
        probe_out = _closure(probe_l)["probe_step"](*probe_args)
        full_out = _closure(full_l)["full_step"](*full_args)
    return {"bb_vars": _np_tree(_closure(extract)["bb_vars"]), "images": np.asarray(images),
            "depth": np.asarray(depth), "feats": [np.asarray(f.astype(jnp.float32)) for f in feats],
            "params": _np_tree(params), "stats": _np_tree(stats),
            "probe": _np_tree(probe_out), "full": _np_tree(full_out)}


def _port_steps(jax_steps):
    steps = time_suite.build_steps("test_tiny_vit", 2, (32, 32), "dpt", "float32",
                                   hidden_dim=32, device="cpu")
    np.testing.assert_array_equal(steps.images.numpy(), jax_steps["images"])
    np.testing.assert_array_equal(steps.depth.numpy(), jax_steps["depth"])
    steps.backbone.module.load_state_dict(vit_state_dict(jax_steps["bb_vars"]))
    steps.modules.load_state_dict(trainer_state_dict(jax_steps["params"], jax_steps["stats"]))
    return steps


def _check_step(steps, loss, jax_out):
    """The port's loss, gradients and updated modules against the JAX step's
    output ``(params, stats, opt_state, loss)``; the JAX gradients are its
    first moment over (1 - β1)."""
    new_params, new_stats, opt_state, jloss = jax_out
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = trainer_state_dict(new_params, new_stats)
    jgrads = {k: v.numpy() / np.float32(1 - B1)
              for k, v in trainer_state_dict(opt_state[0].mu).items()}
    got = steps.modules.state_dict()
    grads = {k: p.grad.numpy() for k, p in steps.modules.named_parameters()}
    assert grads.keys() == jgrads.keys()
    n_flips = 0
    for name, ref in want.items():
        ref, out = ref.numpy(), got[name].numpy()
        tol = 1e-5 * np.abs(ref).max()
        if name not in grads:  # BatchNorm running statistics
            np.testing.assert_allclose(out, ref, rtol=0, atol=tol, err_msg=name)
            continue
        g = np.abs(jgrads[name])
        assert g.max() > 0, name
        np.testing.assert_allclose(grads[name], jgrads[name], rtol=0,
                                   atol=SURE_GRAD * g.max(), err_msg=name)
        sure = g > SURE_GRAD * g.max()
        np.testing.assert_allclose(out[sure], ref[sure], rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2 * LR + tol, err_msg=name)
        n_flips += int((np.abs(out - ref) > tol).sum())
    return n_flips


def test_probe_step_matches_the_jax_step(jax_steps, one_torch_thread):
    steps = _port_steps(jax_steps)
    feats = [torch.from_numpy(f.copy()).to(torch.bfloat16) for f in jax_steps["feats"]]
    loss = steps.probe_step(feats, steps.depth)
    _check_step(steps, loss, jax_steps["probe"])


def test_full_step_matches_the_jax_step(jax_steps, one_torch_thread):
    """The full step through the port's extractor fed the JAX bf16 taps (its
    forward still counted) is held as the probe step is; with its own bf16
    forward, whose taps differ from XLA's by an ulp on 58-71% of the values
    (at most 1.1e-2 of max|tap|), the loss moves by 3.2e-5 relative and is
    held to 1e-4."""
    steps = _port_steps(jax_steps)
    own = steps.extract(steps.images)
    assert all(f.dtype == torch.bfloat16 for f in own) and len(own) == 4
    for f, ref in zip(own, jax_steps["feats"]):
        np.testing.assert_allclose(f.float().numpy(), ref, rtol=0,
                                   atol=2**-6 * np.abs(ref).max())
    np.testing.assert_allclose(float(steps.full_step(steps.images, steps.depth)),
                               float(jax_steps["full"][3]), rtol=1e-4)

    steps = _port_steps(jax_steps)
    taps = [torch.from_numpy(f.copy()) for f in jax_steps["feats"]]
    steps.backbone._apply_fn = lambda images: (taps, [None] * len(taps))
    count = steps.backbone.forward_count
    loss = steps.full_step(steps.images, steps.depth)
    assert steps.backbone.forward_count == count + 1
    _check_step(steps, loss, jax_steps["full"])


TIMES = {"dino_vitb16": {("dpt", "f32"): (0.0191, 0.1012, 0.1203),
                         ("dpt", "bf16"): (0.0187, 0.0734, 0.0921),
                         ("linear", "bf16"): (0.0183, 0.0032, 0.0215)},
         "simclr_resnet50": {("dpt", "bf16"): (0.0121, 0.0913, 0.1034),
                             ("linear", "bf16"): (0.0119, 0.0041, 0.0160)}}


def _decimals(line: str) -> list:
    return re.findall(r"\d+\.\d+", line)


def test_projection_equals_the_jax_report_row_by_row(tmp_path, monkeypatch):
    def j_measure(name, batch, hw=(480, 480), head_type="dpt", probe_dtype=jnp.float32,
                  hidden_dim=512):
        return TIMES[name][(head_type, probe_dtype.__name__.replace("float", "f"))]

    monkeypatch.setattr(J_TS, "measure_backbone", j_measure)
    assert J_TS.main(["--out", str(tmp_path / "jax.md")]) == 0

    monkeypatch.setattr(time_suite, "require_device", lambda device: None)
    monkeypatch.setattr(time_suite, "build_steps",
                        lambda name, batch, hw, head, pdt, **kw: (name, head, pdt))

    def t_times(steps, iters=10):
        name, head, pdt = steps
        te, tp, tf = TIMES[name][(head, pdt.replace("float", "f"))]
        return {"extract_s": te, "probe_s": tp, "full_s": tf, "probe_loss": 1.0,
                "full_loss": 1.0}

    monkeypatch.setattr(time_suite, "time_steps", t_times)
    res = time_suite.main(["--out", str(tmp_path / "torch.md"), "--device", "cpu"])
    assert [r["tag"] for r in res["rows"]] == [
        "dino_vitb16/dpt-f32", "dino_vitb16/dpt-bf16", "dino_vitb16/linear-bf16",
        "simclr_resnet50/dpt-bf16", "simclr_resnet50/linear-bf16"]
    jlines = (tmp_path / "jax.md").read_text().splitlines()
    tlines = (tmp_path / "torch.md").read_text().splitlines()
    assert len(tlines) == len(jlines)
    rows = [i for i, ln in enumerate(jlines) if ln.startswith("| ") and "/" in ln]
    assert len(rows) == 5
    for i in rows:  # each variant's row: the tag and its three times
        assert tlines[i] == jlines[i]
    for i, (jl, tl) in enumerate(zip(jlines, tlines)):
        if i == 0:  # the device: "1x TPU v5e" there, the card here
            assert tl.startswith("# Suite wall-clock projection (measured on 1x ")
            continue
        assert _decimals(tl) == _decimals(jl), (jl, tl)
        assert ("NOT MET" in tl) == ("NOT MET" in jl) and ("MET" in tl) == ("MET" in jl)
    assert "v4-8" not in "\n".join(tlines) and "4 cards (data-parallel, a projection)" in tlines[-5]
    p = res["projection"]
    assert f"{p['suite_cached'] / 3600:.2f} h" in tlines[-6]


@pytest.mark.parametrize("name", ["simclr_resnet50", "test_tiny_vit"])
@pytest.mark.parametrize("head", ["dpt", "linear"])
def test_every_variant_takes_a_step(name, head, one_torch_thread):
    """The variants of ``main`` on a ResNet (whose one-tap width is a
    ``(C, hw)`` pair) and a ViT: one finite full step each, the loss and
    the probe's trained parameters moved."""
    steps = time_suite.build_steps(name, 1, (64, 64), head, "bfloat16", hidden_dim=32,
                                   device="cpu")
    before = {k: v.clone() for k, v in steps.modules["probe"].state_dict().items()}
    loss = steps.full_step(steps.images, steps.depth)
    assert torch.isfinite(loss)
    after = steps.modules["probe"].state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
