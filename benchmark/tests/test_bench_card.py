"""On a card: one short run of the first extraction and training cells
through the command, its line in the contract's form and correct.
Skipped without a card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import manifest


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dino_b16.extract", "dino_b16.train_dpt"])
def test_a_short_run(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"images_per_s", "setup_s"} <= set(line["metrics"])
