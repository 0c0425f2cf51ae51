"""The port's multi-process plumbing in one process (the 2-rank run is
``tests/test_torch_ddp.py``): ``initialize()`` as a no-op decided without
CUDA or the backend, the identity gathers, the ``system.num_devices``
refusal, the loader's shards (as ``tests/test_multihost.py`` checks the JAX
loader's) and ``utils/profiling.py`` (as ``tests/test_misc_utils.py``
checks the JAX ``time_fn``)."""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from midvision_probe_torch.datasets.builder import Loader
from midvision_probe_torch.engine.probe_fit import ProbeTrainer
from midvision_probe_torch.models import zoo
from midvision_probe_torch.parallel import mesh, multihost
from midvision_probe_torch.utils import profiling

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _refuse(*args, **kwargs):
    raise AssertionError("touched CUDA or the process-group backend")


def test_initialize_is_a_single_process_noop_without_cuda(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(multihost, "_initialized", False)
    for name in ("is_available", "device_count", "set_device", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, _refuse)
    monkeypatch.setattr(dist, "init_process_group", _refuse)
    multihost.initialize()
    multihost.initialize()  # idempotent
    assert multihost._initialized
    assert not multihost.in_process_group()
    assert multihost.process_shard_args() == {"num_shards": 1, "shard_index": 0}
    rows = [{"f": 1.0}]
    assert multihost.gather_rows(rows, ("f",)) is rows
    got = multihost.gather_metrics({"x": [1.0, 2.0]})
    np.testing.assert_array_equal(got["x"], [1.0, 2.0])
    t = torch.ones(3, requires_grad=True)
    with multihost.global_batch():
        assert multihost.batch_sum(t) is t and multihost.batch_stat_sum(t) is t


def test_num_devices_must_be_every_rank_or_the_world_size():
    assert mesh.check_num_devices(-1) == mesh.check_num_devices(1) == 1
    assert mesh.check_num_devices(None) == mesh.check_num_devices(0) == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        mesh.check_num_devices(2)
    backbone = zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, device="cpu")
    with pytest.raises(ValueError, match="system.num_devices=8"):
        ProbeTrainer(backbone, None, None, num_devices=8, device="cpu")


class _Items:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"x": np.asarray([i])}


def test_loader_shards_partition_the_dataset():
    """The union of the shards is the dataset; the shards pad to equal
    lengths by wrapped repeats (23 items in 4 shards: 24 slots), marked
    ``_valid`` false, on every shard when the set does not divide."""
    seen, valid, lens = [], [], set()
    for rank in range(4):
        loader = Loader(_Items(), batch_size=3, num_shards=4, shard_index=rank)
        lens.add(len(loader))
        for b in loader:
            seen.extend(b["x"].reshape(-1).tolist())
            valid.extend(b["_valid"].tolist())
    assert lens == {2} and len(seen) == 24
    assert sorted(x for x, v in zip(seen, valid) if v) == list(range(23))
    assert "_valid" not in next(iter(Loader(_Items(), batch_size=3)))
    with pytest.raises(ValueError, match="shard_index"):
        Loader(_Items(), batch_size=3, num_shards=2, shard_index=None)


def test_time_fn():
    stats = profiling.time_fn(lambda x: x * 2, torch.ones(8, 8), warmup=1, iters=3)
    assert stats["mean_ms"] > 0 and stats["min_ms"] <= stats["p50_ms"] and stats["iters"] == 3


def test_trace_writes_a_chrome_trace_and_memory_stats_report_no_card(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert log_dir == str(tmp_path)
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {"cpu": None}
