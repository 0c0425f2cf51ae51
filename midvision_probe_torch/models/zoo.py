"""Backbone zoo of the PyTorch port (counterpart of the JAX package's
``models/zoo.py``): the plain-ViT entries (DINO ViT-B/16 and B/8, MAE,
iBOT, MoCo v3, MaskFeat, MILAN, EVA, PixMIM, CLIP, SigLIP, CroCo v1 and
v2, RADIO v2, ``test_tiny_vit``), ``load_variables``,
``build_vit_extractor`` and the reference-compatible constructors of
``configs/backbone``.

A released checkpoint under ``$MVP_CHECKPOINT_DIR`` (default
``checkpoints``) is loaded: ``torch.load`` on the CPU, the entry's
``source`` unwrapped, its converter's numpy tree mapped onto the port's
``ViT`` by ``convert.from_jax.vit_state_dict`` and loaded strictly, so a
file whose keys do not match raises. Without a file the entry is
random-initialised from a seeded ``torch.Generator`` (the JAX package
random-initialises too, with JAX's generator; the draws differ, the
distributions match).

Not ported yet: the LayerScale, register and relative-position-bias ViTs
(DINOv2, DINOv2-reg, DeiT-III, BEiT-v2, MiDaS), SAM, ConvNeXt and the
ResNet-50 zoo (``ROADMAP.md`` section 1, item 3). ``DINO`` with a DINOv2
name, ``BEiTV2`` and ``DeIT`` raise ``NotImplementedError`` through
``ViTConfig.check_supported``; the other families' targets do not exist
here, which ``config.instantiate`` reports.
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
    convert_vit_openclip,
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
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    """One released backbone: its architecture (the port takes the plain
    ViTs), where its weights come from and how they convert."""

    name: str  # checkpoint_name in the reference CSVs
    arch: str  # "vit" (the plain-ViT families are the ones ported)
    source: str  # unwrap_checkpoint convention
    filename: str  # expected file under $MVP_CHECKPOINT_DIR
    url: str = ""  # original weight source (provenance only)
    vit: dict | None = None  # ViTConfig kwargs
    converter: str = "timm"  # timm | hf | radio | openclip
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


# --- plain ViTs (reference files: dino.py, mae.py, ibot.py, mocov3.py,
#     maskfeat.py, milan.py, eva.py, pixmlm.py) -----------------------------
register(ZooEntry(
    "dino_vitb16", "vit", "raw", "dino_vitb16.pth",
    url="facebookresearch/dino:dino_vitb16",
    vit=_vit("vit_base", 16, 14),
))
register(ZooEntry(
    "dino_vitb8", "vit", "raw", "dino_vitb8.pth",
    url="facebookresearch/dino:dino_vitb8",
    vit=_vit("vit_base", 8, 28),
))
register(ZooEntry(
    "mae_vitb16", "vit", "raw", "mae_vitb16.bin",
    url="hf:facebook/vit-mae-base",
    vit=_vit("vit_base", 16, pos_embed="sincos2d", layernorm_eps=1e-12),
    converter="hf", prefix="vit.",
))
register(ZooEntry(
    "mae_vitl16", "vit", "raw", "mae_vitl16.bin",
    url="hf:facebook/vit-mae-large",
    vit=_vit("vit_large", 16, pos_embed="sincos2d", layernorm_eps=1e-12),
    converter="hf", prefix="vit.",
))
for _name, _preset, _ds in [
    ("ibot_vitb16", "vit_base", "in1k"),
    ("ibot_vitb16_in22k", "vit_base", "in22k"),
    ("ibot_vitl16", "vit_large", "in1k"),
    ("ibot_vitl16_in22k", "vit_large", "in22k"),
]:
    register(ZooEntry(
        _name, "vit", "state_dict", f"{_name}.pth",
        url=f"bytedance/ibot checkpoint_teacher.pth ({_ds})",
        vit=_vit(_preset, 16, 14),
    ))
register(ZooEntry(
    "mocov3_vitb16", "vit", "mocov3", "mocov3_vitb16.pth.tar",
    url="dl.fbaipublicfiles.com/moco-v3/vit-b-300ep",
    vit=_vit("vit_base", 16, 14),
))
register(ZooEntry(
    "maskfeat_vitb16", "vit", "mmselfsup", "maskfeat_vitb16.pth",
    url="openmmlab mmselfsup maskfeat vit-base-p16",
    vit=_vit("vit_base", 16, 14, final_norm=False),
))
register(ZooEntry(
    "milan_vitb16", "vit", "state_dict", "milan_vitb16.pth",
    url="gdrive MILAN ViT-B/16",
    vit=_vit("vit_base", 16, 14),
))
register(ZooEntry(
    "eva_vitb16", "vit", "mmselfsup", "eva_vitb16.pth",
    url="openmmlab mmselfsup eva-mae-style vit-base-p16",
    vit=_vit("vit_base", 16, 14),
))
register(ZooEntry(
    "pixmim_vitb16", "vit", "mmselfsup", "pixmim_vitb16.pth",
    url="openmmlab mmselfsup pixmim vit-base-p16",
    vit=_vit("vit_base", 16, 14),
))

# --- CLIP / SigLIP (reference clip.py, siglip.py): CLIP's LN before the
#     blocks, bias-free patch conv and quickgelu; SigLIP without a cls token
register(ZooEntry(
    "clip_vitb16", "vit", "openclip", "clip_vitb16_openai.pt",
    url="open_clip ViT-B-16 openai",
    vit=_vit("vit_base", 16, 14, pre_norm=True, patch_bias=False,
             act="quickgelu", layernorm_eps=1e-5),
    converter="openclip",
    image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD,
))
register(ZooEntry(
    "clip_vitb16_laion", "vit", "openclip", "clip_vitb16_laion2b.pt",
    url="open_clip ViT-B-16 laion2b_s34b_b88k",
    vit=_vit("vit_base", 16, 14, pre_norm=True, patch_bias=False,
             layernorm_eps=1e-5),
    converter="openclip",
    image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD,
))
register(ZooEntry(
    "clip_vitl14", "vit", "openclip", "clip_vitl14_openai.pt",
    url="open_clip ViT-L-14 openai",
    vit=_vit("vit_large", 14, 16, pre_norm=True, patch_bias=False,
             act="quickgelu", layernorm_eps=1e-5),
    converter="openclip",
    image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD,
))
register(ZooEntry(
    "siglip_vitb16", "vit", "raw", "siglip_vitb16_384.bin",
    url="timm vit_base_patch16_siglip_384",
    vit=_vit("vit_base", 16, 24, class_token=False, pos_embed_cls=False,
             act="gelu_tanh"),
    default_size=384,
    image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
))
register(ZooEntry(
    "siglip_vitl16", "vit", "raw", "siglip_vitl16_384.bin",
    url="timm vit_large_patch16_siglip_384",
    vit=_vit("vit_large", 16, 24, class_token=False, pos_embed_cls=False,
             act="gelu_tanh"),
    default_size=384,
    image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
))

# --- CroCo v1/v2 (reference croco.py / crocov2.py): the reference wrappers
#     bilinearly resize every input to 224x224 (croco.py:149-153,
#     crocov2.py:152-154), so both always run at N = 196 tokens; v1 adds a
#     sincos table built for that grid, v2 rotates q and k by 2D RoPE
register(ZooEntry(
    "croco_vitb16", "vit", "croco", "CroCo.pth",
    url="naver CroCo v1 (croco.py:9-14)",
    vit=_vit("vit_base", 16, pos_embed="sincos2d", class_token=False),
    fixed_input=224,
))
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
    if entry.arch != "vit" or entry.converter not in ("timm", "hf", "radio", "openclip"):
        raise NotImplementedError(
            f"loading {entry.name} ({entry.arch}, converter {entry.converter!r}) "
            "is not ported to PyTorch yet: the ResNet, ConvNeXt and SAM "
            "converters come with the other backbone families (ROADMAP "
            "section 1, item 3)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = unwrap_checkpoint(ckpt, entry.source)
    if entry.converter == "hf":
        return convert_vit_hf(sd, cfg, prefix=entry.prefix), {}
    if entry.converter == "radio":
        return convert_radio(sd, cfg, prefix=entry.prefix)
    if entry.converter == "openclip":
        return convert_vit_openclip(sd, cfg, prefix=entry.prefix or "visual."), {}
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


def _clean(kwargs: dict) -> dict:
    for k in _COMMON_IGNORED:
        kwargs.pop(k, None)
    return kwargs


def DINO(dino_name="dino", model_name="vitb16", output="dense", layer=-1,
         return_multilayer=False, add_norm=False, return_cls=False,
         checkpoint_name=None, **kw) -> FeatureExtractor:
    """Reference ``dino.py:9`` constructor surface (both the dino and the
    dinov2 hubs; the DINOv2 entries are not ported and raise)."""
    name = checkpoint_name or f"{dino_name}_{model_name}"
    if name.startswith("dinov2_"):  # LayerScale, and registers in "_reg"
        ViTConfig(layerscale=True, num_register_tokens=4 if name.endswith("_reg") else 0
                  ).check_supported()
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **_clean(kw))


def MAE(checkpoint="facebook/vit-mae-base", output="dense", layer=-1,
        return_multilayer=False, add_norm=False, return_cls=False, **kw):
    name = "mae_vitl16" if "large" in checkpoint else "mae_vitb16"
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **_clean(kw))


def iBOT(model_type="base", dataset="in1k", output="dense", layer=-1,
         return_multilayer=False, add_norm=False, return_cls=False, **kw):
    name = f"ibot_vit{'b' if model_type == 'base' else 'l'}16"
    if dataset == "in22k":
        name += "_in22k"
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **_clean(kw))


def MoCoV3(model_name="vitb16", output="dense", layer=-1,
           return_multilayer=False, add_norm=False, return_cls=False, **kw):
    return build_vit_extractor(
        "mocov3_vitb16", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm,
        return_cls=return_cls, **_clean(kw))


def _simple_vit_wrapper(zoo_name: str):
    def ctor(model_name="vitb16", output="dense", layer=-1,
             return_multilayer=False, add_norm=False, return_cls=False, **kw):
        return build_vit_extractor(
            zoo_name, output=output, layer=layer,
            return_multilayer=return_multilayer, add_norm=add_norm,
            return_cls=return_cls, **_clean(kw))

    return ctor


MASKFEAT = _simple_vit_wrapper("maskfeat_vitb16")
MILAN = _simple_vit_wrapper("milan_vitb16")
EVA = _simple_vit_wrapper("eva_vitb16")
PIXMLM = _simple_vit_wrapper("pixmim_vitb16")


def BEiTV2(*args, **kw):
    """Reference ``beit_v2.py``: relative-position bias and LayerScale,
    which the port's ViT refuses (``ViTConfig.check_supported``)."""
    ViTConfig(rel_pos_bias=True, layerscale=True).check_supported()


def DeIT(*args, **kw):
    """Reference ``deit.py`` (DeiT-III): LayerScale, which the port's ViT
    refuses (``ViTConfig.check_supported``)."""
    ViTConfig(layerscale=True).check_supported()


def CLIP(arch="ViT-B-16", checkpoint="openai", output="dense", layer=-1,
         return_multilayer=False, add_norm=False, return_cls=False, **kw):
    """Reference ``clip.py:27-101`` (open_clip visual towers)."""
    name = {
        ("ViT-B-16", "openai"): "clip_vitb16",
        ("ViT-B-16", "laion2b_s34b_b88k"): "clip_vitb16_laion",
        ("ViT-L-14", "openai"): "clip_vitl14",
    }.get((arch, checkpoint), "clip_vitb16")
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **_clean(kw))


def SigLIP(checkpoint="vit_base_patch16_siglip_384", output="dense", layer=-1,
           return_multilayer=False, add_norm=False, return_cls=False, **kw):
    name = "siglip_vitl16" if "large" in checkpoint else "siglip_vitb16"
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **_clean(kw))


def CROCO(model_name="vitb16", output="dense", layer=-1,
          return_multilayer=False, add_norm=False, return_cls=False, **kw):
    """Reference ``croco.py`` constructor surface (``configs/backbone``)."""
    return build_vit_extractor(
        "croco_vitb16", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm,
        return_cls=return_cls, **_clean(kw))


def CROCOV2(model_name="vitb16", output="dense", layer=-1,
            return_multilayer=False, add_norm=False, return_cls=False, **kw):
    """Reference ``crocov2.py`` constructor surface (``configs/backbone``)."""
    return build_vit_extractor(
        "crocov2_vitb16", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm,
        return_cls=return_cls, **_clean(kw))


def RADIO(version="radio_v2", output="dense", layer=-1,
          return_multilayer=False, add_norm=False, **kw):
    """Reference ``radio.py:35`` constructor surface (``configs/backbone``).
    A loaded checkpoint's input conditioner sets the spec's mean/std;
    without one the entry's ImageNet mean/std stand in."""
    kw.pop("return_cls", None)
    return build_vit_extractor(
        "radio_v2", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm, **_clean(kw))
