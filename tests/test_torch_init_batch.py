"""The init batch of ``fit`` (a fault in the port, now repaired): the JAX
``fit`` runs ``trainer.init(next(iter(train_loader)))``, and the NYU train
reader draws every augmentation from one ``RandomState(0)``, so the draw
advances the reader before the first epoch. The abandoned iterator's
producer checks its stop flag only when it puts a batch, so the draw reads
the returned batch, the one being built when the consumer leaves and up to
the two the queue holds: 2-4 batches, set by thread timing.

* Both packages' ``fit`` on a fabricated NYU tree (augmentation on, as the
  config has it): the reader calls made between the start of ``fit`` and
  the first epoch lie in that range in both, counted once the draw's
  producer has finished.
* The NYU case of the surface-normal slice (``test_torch_snorm_slice.py``)
  with augmentation on: a test-side hook reseeds both readers' ``_rng`` to
  one state at ``set_epoch(0)``, after the draw's producer has finished, so
  both epochs see the same augmentations; per-step losses within rtol 1e-4,
  the CSV row within atol 1e-3."""

import dataclasses
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.datasets import builder as t_builder
from midvision_probe_torch.engine import driver_common as t_driver_common
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.datasets import builder as j_builder
from midvision_probe_tpu.engine import checkpoint as j_checkpoint
from midvision_probe_tpu.engine import driver_common as j_driver_common
from midvision_probe_tpu.models import zoo as j_zoo

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from test_torch_nyu import make_nyu_tree  # noqa: E402
from test_torch_snorm_slice import TINY_DINO, _assert_rows_close, _run_both  # noqa: E402
from torch_replicas import TimmViT  # noqa: E402

BATCH, FRAMES = 2, 10


def _join_stale_producers():
    """Wait for every loader producer thread but a live epoch's: the JAX
    loader's abandoned producer is not joined by its iterator."""
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.name.endswith("(produce)"):
            t.join()


class _Counting:
    """A reader that counts its ``__getitem__`` calls."""

    def __init__(self, dataset):
        self.dataset, self.calls = dataset, 0
        self.name = dataset.name

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        self.calls += 1
        return self.dataset[i]


class _StubTrainer:
    """What ``fit`` needs of a trainer; each epoch reads one batch."""

    state = None

    def init(self, batch=None):
        pass

    def train_epoch(self, loader, logger=None, wandb=None):
        next(iter(loader))
        return 0.0

    def state_dict(self):
        return {}


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu")
    make_nyu_tree(str(root / "train"), [f"scene_{i:04d}_{i}" for i in range(FRAMES)],
                  seed=5)
    make_nyu_tree(str(root / "test"), ["nyuv2_test_0", "nyuv2_test_1"], seed=6)
    return root


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_fit_draws_two_to_four_init_batches(nyu_root, tmp_path, monkeypatch, package):
    compose, builder, common = {
        "jax": (j_compose, j_builder, j_driver_common),
        "torch": (t_compose, t_builder, t_driver_common)}[package]
    cfg = compose("snorm_training", [
        "dataset=nyu", f"dataset.train_path={nyu_root / 'train'}",
        f"dataset.test_path={nyu_root / 'test'}", "optimizer=one_epoch",
        f"batch_size={BATCH}"])
    assert cfg.dataset.augment_train
    loader = builder.build_loader(cfg.dataset, "trainval", BATCH, seed=8)
    loader.dataset = reader = _Counting(loader.dataset)
    assert len(loader) == FRAMES // BATCH
    before_epoch = []
    set_epoch = loader.set_epoch

    def counted_set_epoch(epoch):
        _join_stale_producers()
        before_epoch.append(reader.calls)
        set_epoch(epoch)

    monkeypatch.setattr(loader, "set_epoch", counted_set_epoch)
    monkeypatch.setattr(j_checkpoint, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(t_driver_common, "save_checkpoint", lambda *a, **k: None)
    common.fit(cfg, _StubTrainer(), loader, logging.getLogger(__name__), None,
               str(tmp_path), resume=False)
    assert len(before_epoch) == 1
    assert 2 * BATCH <= before_epoch[0] <= 4 * BATCH, before_epoch


def test_train_snorm_nyu_slice_with_augmentation_matches_jax(nyu_root, tmp_path,
                                                            monkeypatch):
    """As ``test_torch_snorm_slice``'s NYU case (a fabricated DINO-layout
    checkpoint that both zoos load, the JAX probe init carried across), with
    ``augment_train`` on and both readers reseeded at ``set_epoch(0)``."""
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    torch.save(TimmViT(dim=64, depth=4, heads=4, patch=16, grid=3, mlp_ratio=2.0,
                       seed=21).state_dict(), ckpt_dir / "dino_vitb16.pth")
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(ckpt_dir))
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, "dino_vitb16",
                            dataclasses.replace(zoo.ZOO["dino_vitb16"], vit=TINY_DINO))
    reseeded = []

    def reseeding(set_epoch):
        def hook(self, epoch):
            set_epoch(self, epoch)
            if epoch == 0 and hasattr(self.dataset, "_rng"):
                _join_stale_producers()
                self.dataset._rng = np.random.RandomState(17)
                reseeded.append(type(self.dataset).__module__)

        return hook

    for builder in (j_builder, t_builder):
        monkeypatch.setattr(builder.Loader, "set_epoch",
                            reseeding(builder.Loader.set_epoch))
    argv = ["backbone=dino_b16", "dataset=nyu", f"dataset.train_path={nyu_root / 'train'}",
            f"dataset.test_path={nyu_root / 'test'}", "probe=snorm_dpt",
            "probe.hidden_dim=32", "optimizer=one_epoch", f"batch_size={BATCH}",
            "+render_images=False"]
    jrow, jax_losses, trow = _run_both(tmp_path, monkeypatch, argv)
    assert [m.split(".")[0] for m in reseeded] == ["midvision_probe_tpu",
                                                   "midvision_probe_torch"]
    assert 0.0 <= trow["d1"] <= trow["d2"] <= trow["d3"] <= 1.0
    _assert_rows_close(jrow, jax_losses, trow, FRAMES // BATCH,
                       "snorm_results_NYUv2_final.csv", tmp_path)
