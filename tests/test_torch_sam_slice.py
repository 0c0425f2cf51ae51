"""The SAM depth slice end to end: the port's ``train_depth`` against the
repository's JAX ``train_depth.run`` with ``backbone=sam_base`` (the preset
narrowed in both packages to width 32 and 4 blocks, 1 and 3 global) from
one fabricated segment_anything file loaded by both zoos, as
``test_torch_sam_convnext_slice.run_slice`` sets out."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_sam_convnext_slice import run_slice  # noqa: E402


def test_train_depth_sam_slice_matches_jax(tmp_path, monkeypatch):
    run_slice(tmp_path, monkeypatch, "sam_base")
