"""Backbone zoo of the PyTorch port (counterpart of the JAX package's
``models/zoo.py``): the ``dino_vitb16``, ``crocov2_vitb16``, ``radio_v2`` and
``test_tiny_vit`` entries, ``load_variables``, ``build_vit_extractor`` and
the reference-compatible ``DINO``, ``CROCOV2`` and ``RADIO`` constructors.

A released checkpoint under ``$MVP_CHECKPOINT_DIR`` (default
``checkpoints``) is loaded: ``torch.load`` on the CPU, the entry's
``source`` unwrapped, its converter's numpy tree mapped onto the port's
``ViT`` by ``convert.from_jax.vit_state_dict`` and loaded strictly, so a
file whose keys do not match raises. Without a file the entry is
random-initialised from a seeded ``torch.Generator`` (the JAX package
random-initialises too, with JAX's generator; the draws differ, the
distributions match).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models.convert import (
    convert_radio,
    convert_vit_hf,
    convert_vit_timm,
    unwrap_checkpoint,
)
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
    arch: str  # "vit" (the only family ported)
    source: str  # unwrap_checkpoint convention
    filename: str  # expected file under $MVP_CHECKPOINT_DIR
    url: str = ""  # original weight source (provenance only)
    vit: dict | None = None  # ViTConfig kwargs
    converter: str = "timm"  # timm | hf | radio
    prefix: str = ""  # key prefix inside the trunk state_dict
    image_mean: tuple = IMAGENET_MEAN
    image_std: tuple = IMAGENET_STD
    default_size: int = 224
    # the reference wrapper resizes every input to fixed_input squared
    fixed_input: int | None = None
    fixed_input_mode: str = "bilinear"


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
    "dino_vitb16", "vit", "raw", "dino_vitb16.pth",
    url="facebookresearch/dino:dino_vitb16",
    vit=_vit("vit_base", 16, 14),
))

# CroCo-v2: the zoo's 2D-RoPE model (no pos-embed table, no cls token); the
# reference wrapper bilinearly resizes every input to 224x224
# (crocov2.py:152-154), so it always runs at N = 196 tokens
register(ZooEntry(
    "crocov2_vitb16", "vit", "croco", "CroCo_V2_ViTBase_BaseDecoder.pth",
    url="naver CroCo v2 (crocov2.py:10-15)",
    vit=_vit("vit_base", 16, pos_embed="none", class_token=False, rope=True),
    fixed_input=224,
))

# RADIO v2 trunk (radio.py:84-115): ViT-H/16 (head dim 80), pos embed on the
# patches only (no cls row) plus a learned cls, every tap through the final
# norm. A loaded checkpoint's input conditioner overrides image_mean/std.
register(ZooEntry(
    "radio_v2", "vit", "state_dict", "radio_v2.pth.tar",
    url="NVlabs RADIO v2 (radio.py:35)",
    vit=_vit("vit_huge", 16, 16, final_norm=True, pos_embed_cls=False),
    converter="radio",
))

# tiny randomly-initialized ViT for smoke tests
register(ZooEntry(
    "test_tiny_vit", "vit", "raw", "__never_exists__.pth",
    vit=dict(patch_size=8, width=32, depth=4, num_heads=2, mlp_ratio=2.0),
    default_size=64,
))


def checkpoint_dir() -> str:
    return os.environ.get("MVP_CHECKPOINT_DIR", "checkpoints")


def load_variables(entry: ZooEntry, cfg: ViTConfig) -> tuple[dict | None, dict]:
    """The entry's checkpoint under ``checkpoint_dir()``, converted: a
    numpy tree in the JAX package's ``ViT`` layout (None when no file is
    there) and the converter's extras (RADIO's input-conditioner
    ``image_mean``/``image_std``)."""
    path = os.path.join(checkpoint_dir(), entry.filename)
    if not os.path.exists(path):
        return None, {}
    if entry.arch != "vit" or entry.converter not in ("timm", "hf", "radio"):
        raise NotImplementedError(
            f"loading {entry.name} ({entry.arch}, converter {entry.converter!r}) "
            "is not ported to PyTorch yet: the ResNet, ConvNeXt, OpenCLIP and "
            "SAM converters come with the other backbone families (ROADMAP "
            "section 1, item 7)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = unwrap_checkpoint(ckpt, entry.source)
    if entry.converter == "hf":
        return convert_vit_hf(sd, cfg, prefix=entry.prefix), {}
    if entry.converter == "radio":
        return convert_radio(sd, cfg, prefix=entry.prefix)
    return convert_vit_timm(sd, cfg, prefix=entry.prefix), {}


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
        # fixed-input models always run at their own size: init there
        g = (entry.fixed_input or init_size or entry.default_size) // cfg.patch_size
        cfg = dataclasses.replace(cfg, table_grid=(g, g))

    multilayers = default_vit_multilayers(cfg.depth)
    if not return_multilayer:
        multilayers = [multilayers[-1] if layer == -1 else layer]

    variables, extras = load_variables(entry, cfg)
    module = ViT(cfg)
    if variables is None:
        log.warning("no checkpoint for %s under %s — random init (feature "
                    "protocol only; place %s there for real features)",
                    name, checkpoint_dir(), entry.filename)
        module = random_init(module)
    else:
        module.load_state_dict(vit_state_dict(variables), strict=True)
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
        image_mean=extras.get("image_mean", entry.image_mean),
        image_std=extras.get("image_std", entry.image_std),
    )
    apply_fn = make_vit_feature_fn(module, multilayers, output,
                                   cfg.num_prefix_tokens, fixed_input=entry.fixed_input,
                                   fixed_input_mode=entry.fixed_input_mode)
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


def CROCOV2(model_name="vitb16", output="dense", layer=-1,
            return_multilayer=False, add_norm=False, return_cls=False, **kw):
    """Reference ``crocov2.py`` constructor surface (``configs/backbone``)."""
    for k in _COMMON_IGNORED:
        kw.pop(k, None)
    return build_vit_extractor(
        "crocov2_vitb16", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm,
        return_cls=return_cls, **kw)


def RADIO(version="radio_v2", output="dense", layer=-1,
          return_multilayer=False, add_norm=False, **kw):
    """Reference ``radio.py:35`` constructor surface (``configs/backbone``).
    A loaded checkpoint's input conditioner sets the spec's mean/std;
    without one the entry's ImageNet mean/std stand in."""
    for k in _COMMON_IGNORED + ("return_cls",):
        kw.pop(k, None)
    return build_vit_extractor(
        "radio_v2", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm, **kw)
