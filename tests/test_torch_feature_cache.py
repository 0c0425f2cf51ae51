"""The feature cache (``system.cache_features``) against the JAX package's:
the loader's epoch-seeded batch order and ``_batch_id``; the port's
``train_depth`` on test_tiny (synthetic data, three epochs of three
batches, the JAX probe init carried across) against the JAX driver, the
nine per-step losses within 1e-4 relative and the CSV column for column
within 1e-3; the backbone forwards per epoch and the
tiers' bytes in both engines under the default budgets, the host tier
alone (``MVP_FEATURE_CACHE_DEVICE_GB=0``) and no budget (both 0); the
refusal of a loader that shuffles samples. The JAX side runs under
``jax.default_matmul_precision("float32")`` on one device.

In the driver comparison the port's extractor returns the JAX backbone's
features of each batch (its forward still counted): the cache rounds features
to bf16, which turns the two backbones' float32 differences (up to 3e-6
here) into one-ulp flips of 32 of the 98,304 feature values, and those
move the trained probe's metrics by up to 3e-4 (up to one pixel in the
thresholded columns). Backbone parity is the other slice tests' subject;
this one holds the cache, the loader order, the training and the CSV.
Even on identical features the CSV columns part by up to 2e-4 relative
(the prediction variances) and one pixel (the thresholded d1-d3) after
nine AdamW steps, which normalise float32 rounding differences of
near-zero gradients into whole updates; hence 1e-3, the tolerance of the
uncached slice test (``tests/test_torch_train.py``)."""

import copy
import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

import train_depth as j_train_depth
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.datasets import build_loader as t_build_loader
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.engine.driver_common import cache_shuffle_kwargs
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.models.feature_extractor import FeatureExtractor
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.datasets import build_loader as j_build_loader
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
ARGV = ["backbone=test_tiny", "dataset=synthetic", "probe=depth_dpt", "probe.hidden_dim=32",
        "optimizer=one_epoch", "optimizer.n_epochs=3", "batch_size=4",
        "dataset.num_instances=12", "+render_images=False", "system.cache_features=true"]
N_BATCHES = 3  # 12 items in batches of 4
CSV_NAME = "depth_results_synthetic_final.csv"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's CPU work, restored after: beside
    the other workers of a parallel test run the cores are oversubscribed,
    and torch's thread barriers then make its many small ops an order of
    magnitude slower (the port's cached ``train_depth`` here: 3.7 s alone,
    76 s beside ten busy processes, 6 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batch_order_and_ids_match_jax():
    cfg = t_compose("depth_training", ["dataset=synthetic", "dataset.num_instances=20",
                                       "system.cache_features=true"])
    kw = cache_shuffle_kwargs(cfg)
    assert kw == {"shuffle": False, "shuffle_batch_order": True}
    tl = t_build_loader(cfg.dataset, "trainval", 4, seed=8, **kw)
    jl = j_build_loader(j_compose("depth_training", ["dataset=synthetic",
                                                     "dataset.num_instances=20"]).dataset,
                        "trainval", 4, seed=8, **kw)
    orders = []
    for ep in range(3):
        tl.set_epoch(ep)
        jl.set_epoch(ep)
        tb, jb = list(tl), list(jl)
        assert [b["_batch_id"] for b in tb] == [b["_batch_id"] for b in jb]
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t["image"], j["image"])
        orders.append([b["_batch_id"] for b in tb])
    assert all(sorted(o) == list(range(5)) for o in orders) and orders[0] != orders[1]
    assert cache_shuffle_kwargs(t_compose("depth_training", ["dataset=synthetic"])) == {}


def test_a_shuffling_loader_is_refused():
    cfg = t_compose("depth_training", ["backbone=test_tiny", "dataset=synthetic",
                                       "dataset.num_instances=8"])
    backbone = t_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, device="cpu")
    trainer = t_probe_fit.ProbeTrainer(backbone, None, None, device="cpu", cache_features=True)
    with pytest.raises(ValueError, match="shuffle_batch_order"):
        trainer.train_epoch(t_build_loader(cfg.dataset, "trainval", 4))


def _counting(monkeypatch, module, counter, counts, trainers):
    """Record each train_epoch's backbone forwards (``counter()`` before and
    after) and the trainer."""
    orig = module.ProbeTrainer.train_epoch

    def train_epoch(self, loader, *a, **k):
        trainers.append(self)
        before = counter()
        out = orig(self, loader, *a, **k)
        counts.append(counter() - before)
        return out

    monkeypatch.setattr(module.ProbeTrainer, "train_epoch", train_epoch)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def test_cached_train_depth_matches_jax(tmp_path, monkeypatch, one_torch_thread):
    jvars = _np_tree(j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)
    init_state, jax_losses, j_counts, j_trainers = {}, [], [], []
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step
    j_extract = j_probe_fit.ProbeTrainer._extract
    extracted = [0]

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
        return st

    def capture_losses(self, cached):
        assert cached
        step = j_make_step(self, cached)

        def wrapped(*args):
            st, loss = step(*args)
            jax_losses.append(float(loss))
            return st, loss

        return wrapped

    def count_extract(self, images):
        extracted[0] += 1
        return j_extract(self, images)

    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_make_train_step", capture_losses)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_extract", count_extract)
    _counting(monkeypatch, j_probe_fit, lambda: extracted[0], j_counts, j_trainers)
    with F32:
        jrow = j_train_depth.run(j_compose("depth_training", ARGV + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    # the JAX backbone's features of every batch the port will see (the
    # loaders' batches are fixed), computed here in one block, so that the
    # port's training never interleaves JAX and torch work
    jax_maps = {}
    for multilayer in (True, False):
        jext = j_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=multilayer,
                                         add_norm=True)
        jax_apply = jax.jit(jext._apply_fn)
        jcfg = j_compose("depth_training", ARGV)
        for split in ("trainval", "test"):
            for batch in j_build_loader(jcfg.dataset, split, 4, seed=8,
                                        **(cache_shuffle_kwargs(jcfg) if split == "trainval"
                                           else {})):
                with F32:
                    maps = jax_apply(jext.variables, batch["image"])[0]
                jax_maps[multilayer, batch["image"].tobytes()] = [np.array(m) for m in maps]
    t_build = t_train_depth.build_backbone

    def jax_features(cfg, needs_multilayer):
        ext = t_build(cfg, needs_multilayer)

        def apply_fn(images):
            maps = jax_maps[ext.return_multilayer, images.numpy().tobytes()]
            return [torch.from_numpy(m) for m in maps], [None] * len(maps)

        ext._apply_fn = apply_fn
        return ext

    t_counts, t_trainers = [], []
    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    monkeypatch.setattr(t_train_depth, "build_backbone", jax_features)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    _counting(monkeypatch, t_probe_fit, lambda: FeatureExtractor.forward_count, t_counts,
              t_trainers)
    trow = t_train_depth.entry(ARGV + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    # every batch extracted once, in epoch 1, and kept in the device tier
    assert t_counts == j_counts == [N_BATCHES, 0, 0]
    jt, tt = j_trainers[-1], t_trainers[-1]
    assert tt._dev_cache_bytes == jt._dev_cache_bytes > 0 and tt._cache_bytes == jt._cache_bytes == 0
    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 3 * N_BATCHES
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    jcsv, tcsv = _read_csv(tmp_path / "jax" / CSV_NAME), _read_csv(tmp_path / "torch" / CSV_NAME)
    assert list(tcsv) == list(jcsv)
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), rtol=1e-3, atol=1e-3, err_msg=k)
        elif k != "exp_name":
            assert tcsv[k] == v, k

    # the other budgets, on the engines the drivers built (the JAX trainer
    # reuses the driver run's compiled step and extraction, and a copy of its
    # state, which the step donates)
    j_state = jax.tree_util.tree_map(lambda x: x.copy(), jt.state)
    for dev_gb, host_gb, want in (("0", "8", [N_BATCHES, 0, 0]),
                                  ("0", "0", [N_BATCHES] * 3)):
        monkeypatch.setenv("MVP_FEATURE_CACHE_DEVICE_GB", dev_gb)
        monkeypatch.setenv("MVP_FEATURE_CACHE_GB", host_gb)
        jnew = dataclasses.replace(jt)
        jnew._train_step, jnew._extract_jit = jt._train_step, jt._extract_jit
        jnew.state = jax.tree_util.tree_map(lambda x: x.copy(), j_state)
        tnew = dataclasses.replace(tt)
        tnew.init()
        for new, build, compose in ((jnew, j_build_loader, j_compose),
                                    (tnew, t_build_loader, t_compose)):
            cfg = compose("depth_training", ARGV)
            loader = build(cfg.dataset, "trainval", 4, seed=8, **cache_shuffle_kwargs(cfg))
            for ep in range(3):
                loader.set_epoch(ep)
                with F32:
                    new.train_epoch(loader)
        assert t_counts[-3:] == j_counts[-3:] == want, (dev_gb, host_gb)
        assert tnew._dev_cache_bytes == jnew._dev_cache_bytes == 0
        assert tnew._cache_bytes == jnew._cache_bytes
        assert (tnew._cache_bytes > 0) == (host_gb != "0")
