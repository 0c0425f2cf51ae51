"""One rank of the port's 2-process gloo run (``tests/test_torch_ddp.py``).

Usage: ``python _torch_worker_2proc.py RANK PORT WORKDIR``. Imports torch
and the port only (no JAX), runs on one CPU thread, joins the group at
``tcp://localhost:PORT`` and writes ``WORKDIR/rank{RANK}.json`` (rank 0
also ``WORKDIR/state.pt``, its trained probe and tap-norms):

* ``ProbeTrainer`` steps on this rank's half of each global batch, the
  backbone and the probe initialised from ``WORKDIR/backbone.pt`` and
  ``WORKDIR/init.pt`` (JAX weights carried across by the parent);
* ``validate`` over a 5-item set in 2 shards (one wrapped repeat);
* a ``BinaryHead`` train-mode step on this rank's half of one input;
* ``gather_rows`` (3 and 2 rows; then none and 2), ``gather_metrics``
  (3 and 1 rows), the loader's shards of a 23-item set, and
  ``pipeline_apply`` over 2 stages;
* the refusals of ``system.num_devices=1`` and of a partial batch;
* ``fit`` for 3 epochs into one ``WORKDIR/fit`` shared by the ranks,
  with the checkpoint files each rank writes, the ones it finds after,
  and the newest restored.
"""

import json
import logging
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from midvision_probe_torch.config.core import Config  # noqa: E402
from midvision_probe_torch.datasets.builder import Loader  # noqa: E402
from midvision_probe_torch.engine import checkpoint  # noqa: E402
from midvision_probe_torch.engine.driver_common import fit  # noqa: E402
from midvision_probe_torch.engine.probe_fit import ProbeTrainer  # noqa: E402
from midvision_probe_torch.models import probes, zoo  # noqa: E402
from midvision_probe_torch.ops.image import resize  # noqa: E402
from midvision_probe_torch.parallel import multihost  # noqa: E402
from midvision_probe_torch.parallel.pipeline import (  # noqa: E402
    pipeline_apply,
    stage_params_sharding,
)
from midvision_probe_torch.utils.losses import binary_cross_entropy, depth_loss  # noqa: E402


class ListLoader:
    """Fixed batches with the ``batch_size`` a train loader has."""

    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter([dict(b) for b in self.batches])

    def set_epoch(self, epoch):
        pass


class Items:
    """A map-style set of ``n`` items, each its index as ``idx`` and as a
    constant image."""

    def __init__(self, n, hw=32):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        image = np.full((self.hw, self.hw, 3), (i + 1) / 10, np.float32)
        return {"image": image, "idx": np.asarray(i, np.int64)}


def depth_loss_fn(pred, batch):
    target = batch["depth"]
    return depth_loss(resize(pred, target.shape[1:3], mode="bilinear"), target)


def make_trainer(workdir, num_devices=-1, n_steps=4):
    backbone_sd = torch.load(os.path.join(workdir, "backbone.pt"))

    def load_jax_vit(module, seed=0):
        module.load_state_dict(backbone_sd)
        return module

    zoo.random_init = load_jax_vit
    backbone = zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, device="cpu")
    probe = probes.DepthHead(feat_dim=backbone.feat_dim, head_type="dpt",
                             prediction_type="bindepth", hidden_dim=16, kernel_size=3)
    return ProbeTrainer(backbone, probe, depth_loss_fn, probe_lr=5e-3, n_steps=n_steps,
                        warmup_steps=1.0, add_norm=True, num_devices=num_devices,
                        device="cpu")


def main():
    rank, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    multihost.initialize(init_method=f"tcp://localhost:{port}", world_size=2, rank=rank,
                         device="cpu")
    out = {"world_size": multihost.world_size(), "rank": multihost.rank(),
           "backend": torch.distributed.get_backend(),
           "shard": multihost.process_shard_args()}
    data = np.load(os.path.join(workdir, "inputs.npz"))

    # --- the global-batch step: this rank's half of every global batch
    half = data["images"].shape[1] // 2
    rows = slice(rank * half, (rank + 1) * half)
    batches = [{"image": data["images"][s, rows], "depth": data["depths"][s, rows]}
               for s in range(data["images"].shape[0])]
    trainer = make_trainer(workdir)
    trainer.init()
    trainer.modules.load_state_dict(torch.load(os.path.join(workdir, "init.pt")))
    before = multihost.counts["all_reduce"]
    trainer.train_epoch(ListLoader(batches, half))
    out["losses"] = trainer.step_losses
    out["all_reduces_per_step"] = (multihost.counts["all_reduce"] - before) / len(batches)
    if rank == 0:
        torch.save(trainer.modules.state_dict(), os.path.join(workdir, "state.pt"))

    # --- validate: 5 items in 2 shards, the repeat dropped, rank order
    val = trainer.validate(Loader(Items(5), 2, **multihost.process_shard_args()),
                           lambda pred, batch: {"idx": batch["idx"],
                                                "mean": pred.mean(dim=(1, 2, 3))})
    out["val_idx"] = val["idx"].tolist()
    out["val_mean"] = val["mean"].tolist()

    # --- the refusals
    for name, fn in (("num_devices", lambda: make_trainer(workdir, num_devices=1)),
                     ("partial_batch", lambda: trainer.train_epoch(
                         ListLoader([batches[0]], half + 1)))):
        try:
            fn()
            out[f"refused_{name}"] = ""
        except ValueError as e:
            out[f"refused_{name}"] = str(e)

    # --- BinaryHead: one train step on this rank's half of one input
    torch.manual_seed(0)
    head = probes.BinaryHead(feat_dim=[8] * 4, head_type="dpt", output_dim=1, hidden_dim=8)
    feats = [torch.from_numpy(f[rows]) for f in
             (data["bin_feat0"], data["bin_feat1"], data["bin_feat2"], data["bin_feat3"])]
    head.train()
    with multihost.global_batch():
        pred = head(feats)
        target = torch.from_numpy(data["bin_target"][rows])
        loss = binary_cross_entropy(resize(pred, target.shape[1:3]), target)
        loss.backward()
    multihost.all_reduce_grads(head.parameters())
    out["bin_loss"] = float(loss)
    out["bin_running_mean"] = head.batch_norm.running_mean.tolist()
    out["bin_running_var"] = head.batch_norm.running_var.tolist()
    out["bin_grads"] = {k: p.grad.reshape(-1).tolist() for k, p in head.named_parameters()
                        if k == "decoder.out_conv_1.weight" or k.startswith("batch_norm")}

    # --- the gathers, uneven and empty
    mine = [{"f": 10.0 * rank + j, "iou": 0.1 * j} for j in range(3 - rank)]
    out["rows"] = multihost.gather_rows(mine, ("f", "iou"))
    out["rows_empty"] = multihost.gather_rows(mine if rank else [], ("f", "iou"))
    n = 3 if rank == 0 else 1
    metrics = multihost.gather_metrics({"x": np.arange(n, dtype=np.float32) + 100 * rank,
                                        "ok": np.arange(n) % 2 == 0})
    out["metrics_x"] = metrics["x"].tolist()
    out["metrics_ok"] = metrics["ok"].tolist()

    # --- the loader's shards of 23 items, wrapped to 24, with batch ids
    loader = Loader(Items(23, hw=2), 3, shuffle_batch_order=True, seed=5,
                    **multihost.process_shard_args())
    loader.set_epoch(1)
    out["loader_len"] = len(loader)
    out["loader_items"] = [int(i) for b in loader for i in b["idx"]]
    out["loader_valid"] = [bool(v) for b in loader for v in b["_valid"]]
    out["loader_batch_ids"] = [int(b["_batch_id"]) for b in loader]

    # --- the GPipe runner over the 2 ranks
    stacked = {"w": torch.from_numpy(data["pipe_w"]), "b": torch.from_numpy(data["pipe_b"])}
    x = torch.from_numpy(data["pipe_x"])

    def stage_fn(p, h):
        return h + torch.tanh(h @ p["w"] + p["b"])

    local = stage_params_sharding(stacked)
    out["pipeline"] = {str(m): pipeline_apply(stage_fn, local, x, n_micro=m).tolist()
                       for m in (2, 4)}

    # --- fit: 3 epochs, both ranks checkpointing into one directory
    fit_trainer = make_trainer(workdir, n_steps=3 * len(batches))
    exp_dir = os.path.join(workdir, "fit")
    saved, real_save = [], torch.save

    def counted_save(obj, f, *args, **kwargs):
        saved.append(os.path.basename(str(f)))
        return real_save(obj, f, *args, **kwargs)

    torch.save = counted_save
    try:
        fit(Config(optimizer=Config(n_epochs=3)), fit_trainer, ListLoader(batches, half),
            logging.getLogger("fit"), None, exp_dir, resume=False)
    finally:
        torch.save = real_save
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    state, epoch = checkpoint.restore_checkpoint(ckpt_dir)
    out["fit_saved"] = saved
    out["fit_ckpts"] = sorted(os.listdir(ckpt_dir))
    out["fit_restored_epoch"] = epoch
    out["fit_restored_gap"] = max(float((state["modules"][k] - v).abs().max())
                                  for k, v in fit_trainer.modules.state_dict().items())

    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
