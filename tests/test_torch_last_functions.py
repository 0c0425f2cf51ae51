"""The last public functions of the JAX package with a counterpart in the
port, one case each, on seeded numpy inputs: the objectness mask metrics
and the correspondence error AUC (``utils/metrics.py``), the
scale-invariant depth loss (``utils/losses.py``), the linear LR scaling
rule (``utils/optim.py``), ``flatten_metrics`` (``engine/driver_common.py``),
``to_dict`` and ``register_target_alias`` (``config/core.py``) and the
feature contract's ``OUTPUTS``. Tolerances: 1e-6 relative on float32
results (1e-5 for the square-rooted loss), exact on the rest. The JAX
side runs under ``jax.default_matmul_precision("float32")``. Also the
port's name for the SD VAE's ResNet block (``VAEResnet`` in the JAX
package, the UNet's ``ResnetBlock`` in the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.config import core as t_core
from midvision_probe_torch.engine import driver_common as t_driver_common
from midvision_probe_torch.models import feature_extractor as t_fe
from midvision_probe_torch.utils import losses as t_losses
from midvision_probe_torch.utils import metrics as t_metrics
from midvision_probe_torch.utils import optim as t_optim
from midvision_probe_tpu.config import core as j_core
from midvision_probe_tpu.engine import driver_common as j_driver_common
from midvision_probe_tpu.models import feature_extractor as j_fe
from midvision_probe_tpu.utils import losses as j_losses
from midvision_probe_tpu.utils import metrics as j_metrics
from midvision_probe_tpu.utils import optim as j_optim

F32 = jax.default_matmul_precision("float32")


def _masks(seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(3, 24, 20).astype(np.float32)
    b = rng.rand(3, 24, 20).astype(np.float32)
    a[1] = 0.0  # an empty prediction: precision 1, IoU counts the union
    b[2] = 0.0  # an empty target: recall 1
    return a, b


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=1e-7)


def case_mask_iou():
    a, b = _masks(0)
    a[0] = 0.0
    b[0] = 0.0  # both empty: 0, not NaN
    _close(t_metrics.mask_iou(torch.from_numpy(a), torch.from_numpy(b)),
           j_metrics.mask_iou(jnp.asarray(a), jnp.asarray(b)))


def case_mask_accuracy():
    a, b = _masks(1)
    _close(t_metrics.mask_accuracy(torch.from_numpy(a), torch.from_numpy(b)),
           j_metrics.mask_accuracy(jnp.asarray(a), jnp.asarray(b)))


def case_precision_recall():
    a, b = _masks(2)
    tp, tr = t_metrics.precision_recall(torch.from_numpy(b), torch.from_numpy(a))
    jp, jr = j_metrics.precision_recall(jnp.asarray(b), jnp.asarray(a))
    _close(tp, jp)
    _close(tr, jr)


def case_f_score():
    rng = np.random.RandomState(3)
    p = rng.rand(6).astype(np.float32)
    r = rng.rand(6).astype(np.float32)
    p[0] = r[0] = 0.0  # 0/0: NaN -> 0
    _close(t_metrics.f_score(torch.from_numpy(p), torch.from_numpy(r)),
           j_metrics.f_score(jnp.asarray(p), jnp.asarray(r)))


def case_error_auc():
    errors = np.random.RandomState(4).exponential(8.0, size=(5, 40))
    assert t_metrics.error_auc(errors, [5, 10, 20]) == j_metrics.error_auc(errors, [5, 10, 20])


def case_depth_si_loss():
    rng = np.random.RandomState(5)
    gt = (rng.rand(2, 16, 12, 1) * 9 + 0.5).astype(np.float32)
    gt[rng.rand(2, 16, 12, 1) < 0.1] = 0.0  # invalid pixels
    pr = (gt + rng.randn(*gt.shape) * 0.3).clip(0.01, None).astype(np.float32)
    for t_in, j_in in (((pr, gt), (pr, gt)), ((pr[..., 0], gt[..., 0]), (pr[..., 0], gt[..., 0]))):
        _close(t_losses.depth_si_loss(*map(torch.from_numpy, t_in)),
               j_losses.depth_si_loss(*map(jnp.asarray, j_in)), rtol=1e-5)


def case_get_linear_scaled_lr():
    for args in ((5e-4, 64, 256), (1e-3, 8, 8), (3e-4, 32, 128)):
        assert t_optim.get_linear_scaled_lr(*args) == j_optim.get_linear_scaled_lr(*args)


def case_flatten_metrics():
    rng = np.random.RandomState(6)
    glob = {"d1": rng.rand(4).astype(np.float32), "rmse": rng.rand(4).astype(np.float32)}
    levels = {"stuff": {"d1": rng.rand(4).astype(np.float32)},
              "level_1": {"rmse": rng.rand(4).astype(np.float32)}}
    t_row = t_driver_common.flatten_metrics(glob, levels, prefix="sa_")
    j_row = j_driver_common.flatten_metrics(glob, levels, prefix="sa_")
    assert list(t_row) == list(j_row) and t_row == j_row


def case_to_dict():
    t_cfg = t_core.compose("depth_training", ["backbone=test_tiny", "dataset=synthetic"])
    j_cfg = j_core.compose("depth_training", ["backbone=test_tiny", "dataset=synthetic"])
    t_plain, j_plain = t_core.to_dict(t_cfg), j_core.to_dict(j_cfg)
    assert type(t_plain) is dict and type(t_plain["backbone"]) is dict
    assert t_plain == j_plain


def case_register_target_alias(monkeypatch):
    monkeypatch.setattr(t_core, "_TARGET_ALIASES", {})
    monkeypatch.setattr(j_core, "_TARGET_ALIASES", {})
    for core, prefix in ((t_core, "midvision_probe_torch"), (j_core, "midvision_probe_tpu")):
        core.register_target_alias("legacy.Synthetic",
                                   "midvision_probe_tpu.datasets.synthetic.SyntheticDepth")
        obj = core.instantiate({"_target_": "legacy.Synthetic", "num_instances": 3,
                                "image_size": [8, 8]})
        assert type(obj).__module__ == f"{prefix}.datasets.synthetic"
        assert type(obj).__name__ == "SyntheticDepth" and len(obj) == 3


def case_outputs():
    assert t_fe.OUTPUTS == j_fe.OUTPUTS == ("cls", "gap", "dense", "dense-cls")
    tokens, cls = torch.randn(2, 6, 4), torch.randn(2, 4)
    for out in t_fe.OUTPUTS:  # each named mode is one the contract builds
        t_fe.tokens_to_output(out, tokens, cls, (2, 3))


def case_vae_resnet_block():
    from midvision_probe_torch.models.sd.unet import ResnetBlock
    from midvision_probe_torch.models.sd.vae import VAEEncoder, VAEEncoderConfig
    from midvision_probe_tpu.models.sd import vae as j_vae

    assert hasattr(j_vae, "VAEResnet")
    enc = VAEEncoder(VAEEncoderConfig(block_out_channels=(32, 32), norm_groups=8))
    names = [n for n, m in enc.named_children() if isinstance(m, ResnetBlock)]
    assert names == ["down_0_res_0", "down_0_res_1", "down_1_res_0", "down_1_res_1",
                     "mid_res_0", "mid_res_1"]


CASES = {"mask_iou": case_mask_iou, "mask_accuracy": case_mask_accuracy,
         "precision_recall": case_precision_recall, "f_score": case_f_score,
         "error_auc": case_error_auc, "depth_si_loss": case_depth_si_loss,
         "get_linear_scaled_lr": case_get_linear_scaled_lr,
         "flatten_metrics": case_flatten_metrics, "to_dict": case_to_dict,
         "register_target_alias": case_register_target_alias, "OUTPUTS": case_outputs,
         "VAEResnet": case_vae_resnet_block}


@pytest.mark.parametrize("name", sorted(CASES))
def test_last_public_function_matches_jax(name, monkeypatch):
    fn = CASES[name]
    with F32:
        if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
            fn(monkeypatch)
        else:
            fn()
