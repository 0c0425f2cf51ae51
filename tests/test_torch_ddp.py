"""The port's data parallelism in one real 2-process gloo run on the CPU
(``tests/_torch_worker_2proc.py``; both ranks import torch and the port
only, one thread each, and must finish within 240 s).

The step of two ranks must be the step of the global batch (the ranks'
halves concatenated in rank order), as the JAX package's jitted step over
globally sharded arrays is: the JAX single-process step on the global
batch is the oracle (its own 2-process run equals it,
``tests/test_multihost_2proc.py``). The ranks hold different numbers of
valid depth pixels, so a per-rank average of losses or gradients would not
be that step; the tap-norms are on, so their batch statistics must be
global too. Checked here:

* the per-step losses against the JAX trainer's within rtol 1e-4 (the bar
  of ``tests/test_torch_train.py``), and against the port's one-process
  run on the global batch within 1e-6 relative; the trained probe and
  tap-norm parameters and running statistics within 1e-5 of the largest
  |param| (read: 2.0e-6, on ``probe.decoder.ref_0.resConfUnit2.conv1
  .weight``). A bar of 1e-6 is not met in float32, and the witness is the
  port's one-process run on the same global batches with their two halves
  swapped, the same step in exact arithmetic with its batch sums in
  another order: it ends 2.1e-6 of max|param| from the unswapped run, on
  the same weight, and its losses within 1.1e-7 relative. The gap is the
  rounding of a reordered sum, which AdamW's normalised update turns into
  a whole step's difference for a gradient near zero. A per-rank average
  of the gradients, the plain DDP step, with per-rank BatchNorm
  statistics, ends 0.78 of max|param| away, so the bar separates the two
  steps;
* ``BinaryHead``'s BatchNorm running statistics (1e-6) and its weight
  gradients (1e-5 of max|grad|, read 4.6e-6; the pre-BatchNorm bias's
  gradient is zero up to rounding and is left out) against one process on
  the concatenated batch;
* ``validate`` dropping a shard's wrapped repeat and gathering in rank
  order (1e-6 against one process);
* ``gather_rows`` (3 and 2 rows, then none and 2) and ``gather_metrics``
  (3 and 1 rows) in rank order; the loader's shards partitioning a 23-item
  set with equal lengths; ``pipeline_apply`` on 2 stages against the
  stages in sequence (1e-6); the refusals of ``num_devices=1`` in a world
  of 2 and of a partial batch;
* ``fit`` for 3 epochs into one directory the ranks share: rank 0 alone
  writes the checkpoints (the JAX save writes from the primary host behind
  barriers), both ranks find the two newest and restore epoch 3, equal to
  their own state.

The JAX side runs under ``jax.default_matmul_precision("float32")``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine.probe_fit import ProbeTrainer as TProbeTrainer
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.ops.image import resize as t_resize
from midvision_probe_torch.utils import losses as t_losses
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import probes as j_probes
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.ops.image import resize as j_resize
from midvision_probe_tpu.utils import losses as j_losses

F32 = jax.default_matmul_precision("float32")
STEPS, GLOBAL_BATCH, HW = 2, 4, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng):
    """Global batches whose halves hold different valid-pixel counts (rank
    0's depth maps have a quarter of their pixels zeroed, rank 1's none),
    the BinaryHead's features and targets, and the pipeline's stages."""
    images = rng.rand(STEPS, GLOBAL_BATCH, HW, HW, 3).astype(np.float32)
    depths = (0.5 + 4 * rng.rand(STEPS, GLOBAL_BATCH, HW, HW, 1)).astype(np.float32)
    depths[:, : GLOBAL_BATCH // 2, : HW // 2, : HW // 2] = 0.0
    out = {"images": images, "depths": depths,
           "bin_target": (rng.rand(GLOBAL_BATCH, 16, 16, 1) > 0.5).astype(np.float32),
           "pipe_w": (rng.randn(2, 8, 8) * 0.3).astype(np.float32),
           "pipe_b": (rng.randn(2, 8) * 0.1).astype(np.float32),
           "pipe_x": rng.randn(8, 8).astype(np.float32)}
    for i in range(4):
        out[f"bin_feat{i}"] = rng.randn(GLOBAL_BATCH, 4, 4, 8).astype(np.float32)
    return out


def _jax_oracle(data):
    """The JAX trainer's init and per-step losses on the global batches."""
    jext = j_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, add_norm=True)
    jhead = j_probes.DepthHead(feat_dim=jext.feat_dim, head_type="dpt",
                               prediction_type="bindepth", hidden_dim=16, kernel_size=3)

    def loss_fn(pred, batch):
        target = batch["depth"]
        return j_losses.depth_loss(j_resize(pred, target.shape[1:3], mode="bilinear"), target)

    trainer = j_probe_fit.ProbeTrainer(jext, jhead, loss_fn, probe_lr=5e-3, n_steps=4,
                                       warmup_steps=1.0, add_norm=True, num_devices=1)
    batches = [{"image": data["images"][s], "depth": data["depths"][s]}
               for s in range(STEPS)]
    losses = []
    step = trainer._make_train_step(False)

    def wrapped(*args):
        st, loss = step(*args)
        losses.append(float(loss))
        return st, loss

    trainer._train_step = wrapped
    with F32:
        st = trainer.init(batches[0])
        init = (_np_tree(st.params), _np_tree(st.batch_stats))
        trainer.train_epoch(batches)
    return _np_tree(jext.variables), init, losses


def _port_one_process(workdir, data, per_rank_average=False):
    """The port's trainer in this process on the global batches, or, with
    ``per_rank_average``, on each half alone with the two gradients
    averaged (the plain DDP step)."""
    backbone_sd = torch.load(os.path.join(workdir, "backbone.pt"))

    def load(module, seed=0):
        module.load_state_dict(backbone_sd)
        return module

    orig = t_zoo.random_init
    t_zoo.random_init = load
    try:
        backbone = t_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True,
                                             device="cpu")
    finally:
        t_zoo.random_init = orig
    probe = t_probes.DepthHead(feat_dim=backbone.feat_dim, head_type="dpt",
                               prediction_type="bindepth", hidden_dim=16, kernel_size=3)

    def loss_fn(pred, batch):
        target = batch["depth"]
        return t_losses.depth_loss(t_resize(pred, target.shape[1:3], mode="bilinear"), target)

    trainer = TProbeTrainer(backbone, probe, loss_fn, probe_lr=5e-3, n_steps=4,
                            warmup_steps=1.0, add_norm=True, device="cpu")
    trainer.init()
    trainer.modules.load_state_dict(torch.load(os.path.join(workdir, "init.pt")))
    batches = [{"image": data["images"][s], "depth": data["depths"][s]}
               for s in range(STEPS)]
    if per_rank_average:
        half = GLOBAL_BATCH // 2
        for batch in batches:
            trainer.optimizer.zero_grad()
            for rows in (slice(0, half), slice(half, None)):
                part = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
                feats = trainer.backbone.features(part["image"])
                (0.5 * loss_fn(trainer._forward(feats, train=True), part)).backward()
            trainer.optimizer.step()
            trainer.scheduler.step()
        return trainer.modules.state_dict()
    trainer.train_epoch(batches)
    # validate over the 5 items the ranks split (their idx and mean pred)
    items = np.stack([np.full((HW, HW, 3), (i + 1) / 10, np.float32) for i in range(5)])
    with torch.no_grad():
        val = trainer.predict({"image": items}).mean(dim=(1, 2, 3)).numpy()
    return trainer, val


def _binary_one_process(data):
    torch.manual_seed(0)
    head = t_probes.BinaryHead(feat_dim=[8] * 4, head_type="dpt", output_dim=1, hidden_dim=8)
    head.train()
    pred = head([torch.from_numpy(data[f"bin_feat{i}"]) for i in range(4)])
    target = torch.from_numpy(data["bin_target"])
    t_losses.binary_cross_entropy(t_resize(pred, target.shape[1:3]), target).backward()
    return head


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ddp")
    data = _inputs(np.random.RandomState(0))
    np.savez(workdir / "inputs.npz", **data)
    jvars, (params, stats), jax_losses = _jax_oracle(data)
    torch.save(vit_state_dict(jvars), workdir / "backbone.pt")
    torch.save(trainer_state_dict(params, stats), workdir / "init.pt")

    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_torch_worker_2proc.py")
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(port), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    ranks = [json.loads((workdir / f"rank{r}.json").read_text()) for r in (0, 1)]
    one, one_val = _port_one_process(str(workdir), data)
    swapped = {k: v for k, v in data.items()}
    for k in ("images", "depths"):
        swapped[k] = np.concatenate([data[k][:, GLOBAL_BATCH // 2:],
                                     data[k][:, : GLOBAL_BATCH // 2]], axis=1)
    return {"data": data, "ranks": ranks, "jax_losses": jax_losses, "one": one,
            "one_val": one_val, "swapped": _port_one_process(str(workdir), swapped)[0],
            "per_rank_average": _port_one_process(str(workdir), data, per_rank_average=True),
            "state": torch.load(workdir / "state.pt"),
            "binary": _binary_one_process(data)}


def test_ranks_hold_different_valid_pixel_counts(run):
    depths = run["data"]["depths"]
    counts = [(depths[:, :2] > 0).sum(), (depths[:, 2:] > 0).sum()]
    assert counts[0] < counts[1]
    assert [r["world_size"] for r in run["ranks"]] == [2, 2]
    assert [r["backend"] for r in run["ranks"]] == ["gloo", "gloo"]
    assert [r["shard"] for r in run["ranks"]] == [{"num_shards": 2, "shard_index": r}
                                                 for r in (0, 1)]


def test_two_ranks_take_the_global_batch_step(run):
    r0, r1 = run["ranks"]
    assert r0["losses"] == r1["losses"]  # every rank logs the global loss
    assert len(r0["losses"]) == STEPS
    np.testing.assert_allclose(r0["losses"], run["jax_losses"], rtol=1e-4)
    np.testing.assert_allclose(r0["losses"], run["one"].step_losses, rtol=1e-6)
    np.testing.assert_allclose(run["swapped"].step_losses, run["one"].step_losses, rtol=1e-6)
    # a step's all-reduces: the loss sums (sig + 4 gradient scales), two
    # per tap norm (forward, and none backward: the features are frozen)
    # and the gradients
    assert r0["all_reduces_per_step"] > 1


def test_two_ranks_end_with_the_one_process_parameters(run):
    got, want = run["state"], run["one"].modules.state_dict()
    assert set(got) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    swapped = run["swapped"].modules.state_dict()
    for k, v in want.items():
        assert float((got[k] - v).abs().max()) <= 1e-5 * scale, k
        # the witness: the same step with its batch sums in another order
        assert float((swapped[k] - v).abs().max()) <= 1e-5 * scale, k
    # the plain DDP step, a per-rank average, is far outside that bar
    avg = run["per_rank_average"]
    assert max(float((avg[k] - v).abs().max()) for k, v in want.items()) > 1e-3 * scale


def test_validate_drops_the_repeat_and_gathers_in_rank_order(run):
    for r in run["ranks"]:
        assert r["val_idx"] == [0, 2, 4, 1, 3]
        np.testing.assert_allclose(r["val_mean"], run["one_val"][r["val_idx"]], rtol=1e-6)


def test_binary_head_batch_norm_is_global(run):
    head = run["binary"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["bin_running_mean"], head.batch_norm.running_mean,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["bin_running_var"], head.batch_norm.running_var,
                                   rtol=1e-6, atol=1e-7)
        for k, g in r["bin_grads"].items():
            want = dict(head.named_parameters())[k].grad.reshape(-1).numpy()
            assert np.abs(np.asarray(g) - want).max() <= 1e-5 * np.abs(want).max(), k


def test_gathers_are_in_rank_order(run):
    for r in run["ranks"]:
        assert [x["f"] for x in r["rows"]] == [0.0, 1.0, 2.0, 10.0, 11.0]
        np.testing.assert_allclose([x["iou"] for x in r["rows"]], [0, 0.1, 0.2, 0, 0.1])
        assert [x["f"] for x in r["rows_empty"]] == [10.0, 11.0]
        assert r["metrics_x"] == [0.0, 1.0, 2.0, 100.0]
        assert r["metrics_ok"] == [True, False, True, True]


def test_loader_shards_partition_the_dataset(run):
    r0, r1 = run["ranks"]
    assert r0["loader_len"] == r1["loader_len"] == 4  # 23 -> 24 slots, 12 a rank
    items = r0["loader_items"] + r1["loader_items"]
    valid = r0["loader_valid"] + r1["loader_valid"]
    assert len(items) == 24 and sorted(i for i, v in zip(items, valid) if v) == list(range(23))
    assert sum(not v for v in valid) == 1
    assert sorted(r0["loader_batch_ids"]) == sorted(r1["loader_batch_ids"]) == [0, 1, 2, 3]


def test_pipeline_matches_the_stages_in_sequence(run):
    d = run["data"]
    x = torch.from_numpy(d["pipe_x"])
    for s in range(2):
        x = x + torch.tanh(x @ torch.from_numpy(d["pipe_w"][s]) + torch.from_numpy(d["pipe_b"][s]))
    for r in run["ranks"]:
        for m, got in r["pipeline"].items():
            np.testing.assert_allclose(got, x.numpy(), rtol=1e-6, atol=1e-6, err_msg=m)


def test_refusals(run):
    for r in run["ranks"]:
        assert "torchrun" in r["refused_num_devices"]
        assert "full batches" in r["refused_partial_batch"]


def test_fit_checkpoints_are_written_by_rank_0(run):
    for r in run["ranks"]:
        saved = [name.split(".tmp")[0] for name in r["fit_saved"]]
        assert saved == (["epoch_1.pt", "epoch_2.pt", "epoch_3.pt"] if r["rank"] == 0 else [])
        assert r["fit_ckpts"] == ["epoch_2.pt", "epoch_3.pt"]
        assert r["fit_restored_epoch"] == 3
        assert r["fit_restored_gap"] == 0.0
