"""The probe heads' dtypes against the JAX package's (faults F7 and F8).

F7: the ``Linear`` head on bf16 taps. The JAX head resizes an off-grid tap
in float32 and rounds it back to bf16 before the concat and its float32
conv; the port kept the taps in float32 from the trainer on, so on bf16
taps of four grids (ResNet-50's stages) it stood 6.4e-4 (``kernel_size``
1) and 2.2e-3 (3) of max|ref| from the JAX head (measured when the fault
was found; the old head itself refuses bf16 taps). Each tap now keeps its
dtype through the resize; held to 1e-5 of max|ref| (read: 3.5e-7 and
1.1e-6, float32 summation order only).

F8: ``system.probe_dtype=bfloat16``. The JAX heads take ``dtype=bf16``, so
flax rounds at every module, the depth reduction included; the port
autocast its probe and reduced in float32 (6.1e-3 to 7.4e-3 of max|ref|
from JAX bf16 for ``DepthHead`` with bindepth, where a float32 head stands
3.5e-3 to 4.6e-3 from it). Each head is now held, per decoder, with
shared weights on the same float32 taps, to JAX's bf16 head by the mean
error relative to the mean |ref|, ``mean|port - ref| / mean|ref|``, and
must be closer than a float32 head (the control). Readings after the
repair (port / control), linear, multiscale, DPT: bindepth 2.6e-7 /
1.4e-3, 2.9e-5 / 1.6e-3, 2.3e-4 / 1.4e-3; sigdepth 0 / 2.6e-3, 2.9e-6 /
2.2e-3, 5.8e-4 / 5.2e-3; surface normals 1.5e-10 / 2.9e-3, 1.1e-4 /
4.3e-3, 5.4e-4 / 5.2e-3; objectness (BatchNorm in train mode) 0 / 2.3e-3,
9.2e-5 / 3.7e-3, 3.6e-4 / 3.7e-3; Taskonomy (tanh) 0 / 2.8e-3, 1.0e-4 /
5.6e-3, 4.2e-4 / 4.5e-3. The limit, 1e-3, lies between the largest
reading (5.8e-4) and the smallest control (1.4e-3). The maximum errors
stay at a few bf16 ulps of the output for both (the port 0 to 2.4e-2 of
max|ref|, the control 3.4e-3 to 5.5e-2): a float32 accumulation order
that differs from XLA's flips an occasional bf16 rounding (0.016% of one
conv's outputs), and bindepth's bf16 channel sum turns one flip into a
shift of the whole pixel's depth. The JAX side runs under
``jax.default_matmul_precision("float32")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import probe_state_dict
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_tpu.models import probes as j_probes

F32 = jax.default_matmul_precision("float32")
MEAN_LIMIT = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, restored after
    (beside the other workers of a parallel run, torch's thread barriers
    slow them by an order of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_linear_head_resizes_bf16_taps_in_their_dtype(kernel_size):
    """F7: four bf16 taps on ResNet-50's stage grids (32x40, 16x20, 8x10,
    4x5; 8-64 channels) through the float32 ``Linear`` head."""
    rng = np.random.RandomState(0)
    grids = [(32, 40, 8), (16, 20, 16), (8, 10, 32), (4, 5, 64)]
    taps = [jnp.asarray(rng.randn(2, h, w, c).astype(np.float32)).astype(jnp.bfloat16)
            for h, w, c in grids]
    jhead = j_probes.Linear(output_dim=16, kernel_size=kernel_size)
    variables = jhead.init(jax.random.PRNGKey(0), taps)
    with F32:
        ref = np.asarray(jhead.apply(variables, taps))

    thead = t_probes.Linear([(c, h) for h, _, c in grids], 16, kernel_size)
    thead.load_state_dict(probe_state_dict(_np_tree(variables["params"])))
    with torch.no_grad():
        got = thead([torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16()
                     for t in taps])
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _depth(head_type, prediction_type):
    return (j_probes.DepthHead, t_probes.DepthHead,
            dict(head_type=head_type, prediction_type=prediction_type, max_depth=10.0), False)


def _snorm(head_type):
    return (j_probes.SurfaceNormalHead, t_probes.SurfaceNormalHead,
            dict(head_type=head_type, uncertainty_aware=True), False)


def _binary(head_type):
    return j_probes.BinaryHead, t_probes.BinaryHead, dict(head_type=head_type, output_dim=1), True


def _taskonomy(head_type):
    return (j_probes.TaskonomyHead, t_probes.TaskonomyHead,
            dict(head_type=head_type, output_dim=3, pred_type="tanh"), False)


CASES = {f"{name}-{ht}": make(ht, *extra)
         for ht in ("linear", "multiscale", "dpt")
         for name, make, extra in (("bindepth", _depth, ("bindepth",)),
                                   ("sigdepth", _depth, ("sigdepth",)),
                                   ("snorm", _snorm, ()), ("binary", _binary, ()),
                                   ("taskonomy", _taskonomy, ()))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_head_follows_the_jax_dtype_flow(case):
    """F8: the head under ``dtype=bfloat16`` against JAX's, beside a
    float32 head (the control)."""
    jcls, tcls, kw, train = CASES[case]
    kw = dict(kw, feat_dim=[32] * 4, hidden_dim=16, kernel_size=3)
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, 6, 8, 32).astype(np.float32) for _ in range(4)]
    jf = [jnp.asarray(f) for f in feats]
    variables = jcls(**kw).init(jax.random.PRNGKey(1), jf)
    apply_kw = {"train": True, "mutable": ["batch_stats"]} if train else {}
    with F32:
        ref = jcls(**kw, dtype=jnp.bfloat16).apply(variables, jf, **apply_kw)
    ref = np.asarray((ref[0] if train else ref).astype(jnp.float32))

    def port(dtype):
        head = tcls(**kw, dtype=dtype)
        head.load_state_dict(probe_state_dict(_np_tree(variables["params"]),
                                              _np_tree(variables.get("batch_stats", {}))
                                              or None))
        head.train(train)
        with torch.no_grad():
            return head([torch.from_numpy(f) for f in feats])

    got, control = port("bfloat16"), port(None)
    want = torch.float32 if case.startswith("bindepth") else torch.bfloat16
    assert got.dtype == want and tuple(got.shape) == ref.shape

    def mean_err(x):
        return np.abs(x.float().numpy() - ref).mean() / np.abs(ref).mean()

    err, control_err = mean_err(got), mean_err(control)
    assert err <= MEAN_LIMIT < control_err, (err, control_err)
