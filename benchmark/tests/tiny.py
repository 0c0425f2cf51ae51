"""Tiny configurations for the CPU tests: a cell's configuration and mix
with the widths and batch cut down, everything else as committed."""

from __future__ import annotations

import json

from benchmark import manifest

TINY_VIT = dict(patch_size=8, width=32, depth=4, num_heads=2, mlp_ratio=2.0, table_grid=8,
                image_hw=[32, 48], taps=[0, 1, 2, 3])
TINY_LAYERSCALE_ZOO = "bench_tiny_layerscale"


def config(name: str = "dino_b16", dtype: str | None = None) -> dict:
    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())
    cfg.update(TINY_VIT)
    cfg["zoo"] = TINY_LAYERSCALE_ZOO if cfg["layerscale"] else "test_tiny_vit"
    cfg["probe"] = dict(cfg["probe"], hidden_dim=16)
    if dtype is not None:
        cfg["dtype"] = dtype
    return cfg


def mix(name: str) -> dict:
    m = manifest.mix(name)
    m.update(batch=4, check_chunk=2)
    return m


def register_layerscale_zoo(monkeypatch) -> None:
    """A tiny zoo entry with LayerScale, as DINOv2's."""
    from midvision_probe_torch.models import zoo
    monkeypatch.setitem(zoo.ZOO, TINY_LAYERSCALE_ZOO, zoo.ZooEntry(
        TINY_LAYERSCALE_ZOO, "vit", "raw", "__never_exists__.pth",
        vit=dict(patch_size=8, width=32, depth=4, num_heads=2, mlp_ratio=2.0,
                 layerscale=True), default_size=64))
