"""Backbone zoo of the PyTorch port (counterpart of the JAX package's
``models/zoo.py``): the ``dino_vitb16`` and ``test_tiny_vit`` entries,
``build_vit_extractor`` and the reference-compatible ``DINO`` constructor.

No weights ship with the repository, so both entries are random-initialised
from a seeded ``torch.Generator`` (the JAX package random-initialises too,
with JAX's generator; the draws differ, the distributions match). Loading a
released checkpoint is not ported yet and raises if one is present.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from midvision_probe_torch.models.feature_extractor import (
    FeatureExtractor,
    FeatureSpec,
    default_vit_multilayers,
    make_vit_feature_fn,
)
from midvision_probe_torch.models.vit import VIT_PRESETS, ViT, ViTConfig, init_vit_
from midvision_probe_torch.utils.device import resolve_device, resolve_dtype

log = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    name: str  # checkpoint_name in the reference CSVs
    arch: str
    filename: str  # expected file under $MVP_CHECKPOINT_DIR
    url: str = ""  # original weight source (provenance only)
    vit: dict | None = None  # ViTConfig kwargs
    image_mean: tuple = IMAGENET_MEAN
    image_std: tuple = IMAGENET_STD
    default_size: int = 224


def _vit(preset: str, patch: int, table: int | None = None, **kw) -> dict:
    d = dict(VIT_PRESETS[preset])
    d["patch_size"] = patch
    if table is not None:
        d["table_grid"] = (table, table)
    d.update(kw)
    return d


ZOO: dict[str, ZooEntry] = {}


def register(entry: ZooEntry) -> ZooEntry:
    ZOO[entry.name] = entry
    return entry


register(ZooEntry(
    "dino_vitb16", "vit", "dino_vitb16.pth",
    url="facebookresearch/dino:dino_vitb16",
    vit=_vit("vit_base", 16, 14),
))

# tiny randomly-initialized ViT for smoke tests
register(ZooEntry(
    "test_tiny_vit", "vit", "__never_exists__.pth",
    vit=dict(patch_size=8, width=32, depth=4, num_heads=2, mlp_ratio=2.0),
    default_size=64,
))


def checkpoint_dir() -> str:
    return os.environ.get("MVP_CHECKPOINT_DIR", "checkpoints")


def random_init(module: ViT, seed: int = 0) -> ViT:
    """Seeded random init of a ViT (flax-default distributions)."""
    return init_vit_(module, torch.Generator().manual_seed(seed))


def build_vit_extractor(
    name: str,
    output: str = "dense",
    layer: int = -1,
    return_multilayer: bool = False,
    add_norm: bool = False,
    return_cls: bool = False,
    dtype=None,
    init_size: int | None = None,
    checkpoint_name: str | None = None,  # config-surface nicety; ignored
    device=None,
) -> FeatureExtractor:
    """Frozen ViT extractor for zoo entry ``name`` on ``device`` (default
    cuda; raises without a card unless a device is given) in ``dtype``
    (default float32; ``bfloat16`` for the half-precision forward)."""
    if name not in ZOO:
        raise NotImplementedError(
            f"zoo entry {name!r} is not ported to PyTorch yet "
            f"(ported: {sorted(ZOO)})")
    entry = ZOO[name]
    device = resolve_device(device)
    cfg = ViTConfig(**entry.vit)
    if cfg.pos_embed == "learned" and cfg.table_grid is None:
        # pin the canonical pos-embed grid to the init resolution so inputs
        # of any other size resize the table instead of re-shaping the param
        g = (init_size or entry.default_size) // cfg.patch_size
        cfg = dataclasses.replace(cfg, table_grid=(g, g))

    multilayers = default_vit_multilayers(cfg.depth)
    if not return_multilayer:
        multilayers = [multilayers[-1] if layer == -1 else layer]

    if os.path.exists(os.path.join(checkpoint_dir(), entry.filename)):
        raise NotImplementedError(
            f"found {entry.filename} under {checkpoint_dir()}, but loading "
            "released checkpoints is not ported to PyTorch yet")
    log.warning("no checkpoint for %s under %s — random init (feature "
                "protocol only)", name, checkpoint_dir())
    module = random_init(ViT(cfg))
    module = module.to(device=device, dtype=resolve_dtype(dtype))

    feat_dim = cfg.width * (2 if output == "dense-cls" else 1)
    spec = FeatureSpec(
        feat_dim=[feat_dim] * len(multilayers) if return_multilayer else feat_dim,
        patch_size=cfg.patch_size,
        multilayers=tuple(multilayers),
        arch="vit",
        checkpoint_name=name,
        output=output,
        num_layers=cfg.depth,
        add_norm=add_norm,
        image_mean=entry.image_mean,
        image_std=entry.image_std,
    )
    apply_fn = make_vit_feature_fn(module, multilayers, output,
                                   cfg.num_prefix_tokens)
    return FeatureExtractor(apply_fn, module, spec,
                            return_multilayer=return_multilayer,
                            return_cls=return_cls)


_COMMON_IGNORED = ("return_kqv", "fixed_size", "mode_selected", "return_layers")


def DINO(dino_name="dino", model_name="vitb16", output="dense", layer=-1,
         return_multilayer=False, add_norm=False, return_cls=False,
         checkpoint_name=None, **kw) -> FeatureExtractor:
    """Reference ``dino.py:9`` constructor surface (``configs/backbone``)."""
    for k in _COMMON_IGNORED:
        kw.pop(k, None)
    name = checkpoint_name or f"{dino_name}_{model_name}"
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **kw)
