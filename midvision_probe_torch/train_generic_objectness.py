"""Generic-objectness probe trainer of the PyTorch port (counterpart of the
repository's ``train_generic_objectness.py``).

Usage::

    python -m midvision_probe_torch.train_generic_objectness backbone=dino_b16 \\
        dataset=voc probe=binaryhead [+system.backbone_dtype=bfloat16] \\
        [+system.device=cpu]

A ``BinaryHead`` (decoder, flax-rule BatchNorm, sigmoid) trains with BCE on
the binary object masks of VOC and is validated by F-measure (beta² =
0.3), IoU, accuracy and CorLoc. Kept from the reference and the JAX driver:
the 80/20 split of trainval by ``RandomState(42)`` (the reference's
``:503-512``), the bilinear resize of the prediction to the mask's size
(``:407``), the 0.5 binarization, and per-sample metric rows averaged over
the validation set, written to ``final_results_summary_<dataset>.csv``.
Under ``torchrun`` both splits are sharded over the ranks, the step is the
global batch's (the head's BatchNorm statistics included), the per-sample
rows are gathered in rank order and rank 0 writes the CSV row. Runs on
cuda unless ``system.device`` says otherwise. ``system.cache_features``
reuses each training batch's bf16 features across epochs
(``engine/probe_fit.py``).
"""

from __future__ import annotations

import os

import numpy as np

from midvision_probe_torch.config import instantiate, main
from midvision_probe_torch.datasets.builder import Loader
from midvision_probe_torch.engine.checkpoint import restore_checkpoint
from midvision_probe_torch.engine.driver_common import (
    build_backbone,
    build_loader,
    cache_shuffle_kwargs,
    emit_csv,
    fit,
    init_from_loader,
    make_trainer,
    probe_dtype_kwargs,
    setup_experiment,
)
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.losses import binary_cross_entropy
from midvision_probe_torch.utils.objectness import evaluate_binary_masks

METRIC_KEYS = ("F-measure", "IoU", "Accuracy", "CorLoc")


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices
        self.name = getattr(dataset, "name", "dataset")

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


def run(cfg):
    """Train (or restore, with ``is_eval=True``) and validate one objectness
    probe. Returns the CSV row's metrics plus ``train_losses`` (per-step,
    not written to the CSV)."""
    head_type = cfg.probe.get("head_type", "dpt")
    backbone = build_backbone(cfg, needs_multilayer=head_type != "linear")

    # 80/20 random split of trainval (reference :503-512, seed 42)
    full = build_loader(cfg.dataset, "trainval", cfg.batch_size)
    n = len(full.dataset)
    perm = np.random.RandomState(42).permutation(n)
    n_train = int(0.8 * n)
    # the feature cache fixes each batch's composition and permutes the
    # batches' order per epoch (cache_shuffle_kwargs)
    # the random-split subsets take this rank's shard directly
    shard = multihost.process_shard_args()
    train_loader = Loader(_Subset(full.dataset, perm[:n_train]), cfg.batch_size,
                          drop_last=True, seed=cfg.system.get("random_seed", 8), **shard,
                          **(cache_shuffle_kwargs(cfg) or {"shuffle": True}))
    val_loader = Loader(_Subset(full.dataset, perm[n_train:]), cfg.batch_size, **shard)

    probe = instantiate(cfg.probe, feat_dim=backbone.feat_dim, **probe_dtype_kwargs(cfg))
    exp_name, exp_dir, logger, wandb = setup_experiment(
        cfg, "objectness", backbone, f"binary_{head_type}")
    logger.info("experiment: %s (train %d / val %d)", exp_name, n_train, n - n_train)

    def loss_fn(pred, batch):
        target = batch["mask"]
        return binary_cross_entropy(resize(pred, target.shape[1:3], mode="bilinear"),
                                    target)

    trainer = make_trainer(cfg, backbone, probe, loss_fn, len(train_loader))
    if not cfg.get("is_eval", False):
        fit(cfg, trainer, train_loader, logger, wandb, exp_dir)
    else:
        init_from_loader(trainer, val_loader)
        ckpt = cfg.get("ckpt_path", "") or os.path.join(exp_dir, "ckpt")
        restored = restore_checkpoint(ckpt, map_location=trainer.device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt}")
        trainer.load_state_dict(restored[0])

    # per-sample rows, gathered over the ranks in rank order, then their
    # mean (a short last batch weighs by its size)
    rows = []
    for batch in val_loader:
        valid = batch.pop("_valid", None)  # a shard's wrapped repeats
        mask = batch["mask"]
        pred = resize(trainer.predict(batch), mask.shape[1:3], mode="bilinear")
        pred = pred.float().cpu().numpy()
        if valid is not None:
            pred, mask = pred[valid], mask[valid]
            if not len(mask):
                continue
        m = evaluate_binary_masks(pred, mask, reduce=False)
        rows.extend({k: m[k][j] for k in METRIC_KEYS} for j in range(len(m["F-measure"])))
    rows = multihost.gather_rows(rows, METRIC_KEYS)
    row = {k: float(np.mean([r[k] for r in rows])) for k in METRIC_KEYS}
    logger.info("objectness F %.4f IoU %.4f Acc %.4f CorLoc %.4f",
                row["F-measure"], row["IoU"], row["Accuracy"], row["CorLoc"])

    csv_path = os.path.join(
        cfg.get("output_dir", "result"),
        f"final_results_summary_{getattr(full.dataset, 'name', 'voc')}.csv")
    emit_csv(cfg, csv_path, exp_name, backbone, row)
    wandb.log(row)
    wandb.finish()
    return dict(row, train_losses=list(trainer.step_losses))


entry = main("objectness_train")(run)

if __name__ == "__main__":
    entry()
