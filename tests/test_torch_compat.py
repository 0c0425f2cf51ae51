"""The reference's ``evals.*`` config targets in the port
(``midvision_probe_torch/compat``), against the JAX package's compat layer.

A YAML written here names ``evals.models.dino.DINO`` (test_tiny's ViT),
``evals.models.probes.DepthHead`` and ``evals.datasets.nyu.NYU`` (a
fabricated NYU test tree); both packages compose and instantiate it. The
objects' types match by name, the depth head on shared weights matches
the JAX head's forward within 2e-5 (float32 on depth in [0, 10], the
bar of ``tests/test_torch_probes.py``), and the first NYU item is equal
(its image within 1e-6). The JAX side runs under
``jax.default_matmul_precision("float32")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch import compat as t_compat
from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.config import instantiate as t_instantiate
from midvision_probe_torch.convert.from_jax import probe_state_dict
from midvision_probe_tpu import compat as j_compat
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import instantiate as j_instantiate
from test_torch_nyu import make_nyu_tree

F32 = jax.default_matmul_precision("float32")

YAML = """\
backbone:
  _target_: evals.models.dino.DINO
  checkpoint_name: test_tiny_vit
  return_multilayer: true
probe:
  _target_: evals.models.probes.DepthHead
  feat_dim: [32, 32, 32, 32]
  head_type: linear
  prediction_type: bindepth
  kernel_size: 1
dataset:
  _target_: evals.datasets.nyu.NYU
  train_path: {root}/train
  test_path: {root}/test
  split: test
"""


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evals")
    make_nyu_tree(str(root / "test"), ["nyuv2_test_0"])
    (root / "reference.yaml").write_text(YAML.format(root=root))
    return (t_compose("reference", config_dir=str(root)),
            j_compose("reference", config_dir=str(root)))


def test_the_compat_tables_name_the_same_paths():
    assert set(t_compat._MODULES) == set(j_compat._MODULES)
    for path, attrs in j_compat._MODULES.items():
        assert set(t_compat._MODULES[path]) == set(attrs), path


def test_evals_targets_instantiate_against_the_port(configs):
    tcfg, jcfg = configs
    tbb = t_instantiate(tcfg.backbone, device="cpu")
    jbb = j_instantiate(jcfg.backbone)
    assert type(tbb).__name__ == type(jbb).__name__
    assert type(tbb).__module__.startswith("midvision_probe_torch.")

    thead, jhead = t_instantiate(tcfg.probe), j_instantiate(jcfg.probe)
    assert type(thead).__name__ == type(jhead).__name__ == "DepthHead"
    feats = [np.random.RandomState(i).randn(2, 4, 4, 32).astype(np.float32) for i in range(4)]
    jf = [jnp.asarray(f) for f in feats]
    variables = jhead.init(jax.random.PRNGKey(0), jf)
    with F32:
        ref = np.asarray(jhead.apply(variables, jf))
    thead.load_state_dict(probe_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                  variables["params"])))
    with torch.no_grad():
        got = thead([torch.from_numpy(f) for f in feats]).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)

    tds, jds = t_instantiate(tcfg.dataset), j_instantiate(jcfg.dataset)
    assert type(tds).__name__ == type(jds).__name__ and len(tds) == len(jds) == 1
    titem, jitem = tds[0], jds[0]
    assert set(titem) == set(jitem)
    for k, v in jitem.items():
        np.testing.assert_allclose(titem[k], v, atol=1e-6 if k == "image" else 0,
                                   rtol=0, err_msg=k)
