"""The timed probe step of the port's suite-timing tool
(``midvision_probe_torch/launch/time_suite.py``): on the card
``time_steps`` replays ``Steps.graphed_probe_step``'s CUDA graph, on the
CPU it steps eagerly.

* CPU: ``time_steps`` never records a graph, and its losses are those of
  the same sequence of eager calls made by hand on a twin from the same
  seed (exactly: one torch thread).
* Card (skipped elsewhere; no JAX, so a GPU host runs it with
  ``--noconftest``): two eager warm-up steps and three replays against
  five eager steps of a twin with the same ``capturable`` AdamW on the same
  features, the DPT and linear probes in bf16. The losses within 1e-6
  relative and the parameters' 99.9th-percentile difference within 0.01 of
  the learning rate: only the order of cuBLAS's and cuDNN's sums may
  differ (measured on an H100: equal at this size), while a replay that
  did not update them would be ~1 lr off (AdamW's first updates are
  lr·sign(g)).
  The last replay takes copies of the inputs, which it must copy into the
  recorded ones.
"""

import math

import pytest
import torch

from midvision_probe_torch.launch import time_suite


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twins(name, head, device, batch=2, hw=(32, 32)):
    return [time_suite.build_steps(name, batch, hw, head, "bfloat16", hidden_dim=32,
                                   device=device) for _ in range(2)]


def test_time_steps_steps_eagerly_on_the_cpu(monkeypatch, one_torch_thread):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph recorded on the CPU")

    monkeypatch.setattr(time_suite.Steps, "graphed_probe_step", no_graph)
    timed, twin = _twins("test_tiny_vit", "dpt", "cpu")
    t = time_suite.time_steps(timed, iters=2)
    assert all(t[k] > 0 for k in ("extract_s", "probe_s", "full_s"))

    feats = twin.extract(twin.images)
    for _ in range(3):  # warm-up and 2 timed calls
        twin.probe_step(feats, twin.depth)
    probe_loss = float(twin.probe_step(feats, twin.depth))
    for _ in range(3):
        twin.full_step(twin.images, twin.depth)
    full_loss = float(twin.full_step(twin.images, twin.depth))
    assert math.isfinite(probe_loss) and math.isfinite(full_loss)
    assert (t["probe_loss"], t["full_loss"]) == (probe_loss, full_loss)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["dpt", "linear"])
def test_graphed_probe_step_matches_the_eager_step(head):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the card")
    graphed, eager = _twins("test_tiny_vit", head, "cuda", batch=4, hw=(64, 64))
    feats = graphed.extract(graphed.images)
    step = graphed.graphed_probe_step(feats, graphed.depth)
    replayed = [float(step(feats, graphed.depth)) for _ in range(2)]
    replayed.append(float(step([f.clone() for f in feats], graphed.depth.clone())))
    for group in eager.optimizer.param_groups:
        group["capturable"] = True
    for _ in range(2):
        eager.probe_step(feats, eager.depth)
    stepped = [float(eager.probe_step(feats, eager.depth)) for _ in range(3)]
    assert max(abs(a - b) / abs(a) for a, b in zip(stepped, replayed)) <= 1e-6

    def flat(steps):
        return torch.cat([p.detach().reshape(-1) for p in steps.modules.parameters()])

    diff = (flat(graphed) - flat(eager)).abs().sort().values
    assert float(diff[int(0.999 * (diff.numel() - 1))]) <= 0.01 * time_suite.ADAMW_LR
