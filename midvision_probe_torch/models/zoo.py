"""Backbone zoo of the PyTorch port (counterpart of the JAX package's
``models/zoo.py``): the ViT entries (DINO ViT-B/16 and B/8, DINOv2 B/14,
B/14-reg and L/14, MAE, iBOT, MoCo v3, MaskFeat, MILAN, EVA, PixMIM,
DeiT-III B/16 and L/16, BEiT-v2, CLIP, SigLIP, CroCo v1 and v2, MiDaS'
BEiT-L/16, RADIO v2, ``test_tiny_vit``), the SAM image encoders, the three
ConvNeXt-B entries, the 17 SSL ResNet-50 entries, ``load_variables``, the
extractor builders (``build_vit_extractor``, ``build_sam_extractor``,
``build_convnext_extractor``, ``build_resnet_extractor``) and the
reference-compatible constructors of ``configs/backbone``, the SD
featurizers ``DIFT`` and ``Zero123`` (``models/sd/featurizer.py``) among
them: all 53 backbone configs build.

A released checkpoint under ``$MVP_CHECKPOINT_DIR`` (default
``checkpoints``) is loaded: ``torch.load`` on the CPU, the entry's
``source`` unwrapped, its converter's numpy tree mapped onto the port's
``ViT``, ``SAMViT``, ``ConvNeXt`` or ``ResNet50`` by ``convert.from_jax``
and loaded strictly, so a file whose keys do not match raises. Without a file the entry is
random-initialised from a seeded ``torch.Generator`` (the JAX package
random-initialises too, with JAX's generator; the draws differ, the
distributions match).

The SD featurizers load their own files (``sd21/*.bin``,
``zero123/105000.ckpt``) and are standalone, as in the JAX package: they
have no ``FeatureExtractor`` and no driver takes them.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from midvision_probe_torch.convert.from_jax import (
    convnext_state_dict,
    resnet_state_dict,
    sam_state_dict,
    vit_state_dict,
)
from midvision_probe_torch.models import convnext as convnext_mod
from midvision_probe_torch.models import vit_sam
from midvision_probe_torch.models.convert import (
    convert_convnext,
    convert_radio,
    convert_resnet50,
    convert_sam,
    convert_vit_hf,
    convert_vit_openclip,
    convert_vit_timm,
    unwrap_checkpoint,
)
from midvision_probe_torch.models.feature_extractor import (
    FeatureExtractor,
    FeatureSpec,
    default_vit_multilayers,
    make_resnet_feature_fn,
    make_vit_feature_fn,
)
from midvision_probe_torch.models.resnet import RESNET50_FEAT_DIMS, ResNet50, init_resnet_
from midvision_probe_torch.models.vit import VIT_PRESETS, ViT, ViTConfig, init_vit_
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.utils.device import resolve_device, resolve_dtype

log = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    """One released backbone: its architecture, where its weights come from
    and how they convert."""

    name: str  # checkpoint_name in the reference CSVs
    arch: str  # "vit" | "sam" | "convnext" | "resnet"
    source: str  # unwrap_checkpoint convention
    filename: str  # expected file under $MVP_CHECKPOINT_DIR
    url: str = ""  # original weight source (provenance only)
    vit: dict | None = None  # ViTConfig kwargs
    converter: str = "timm"  # timm | hf | radio | openclip (ViTs)
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
    "dinov2_vitb14", "vit", "raw", "dinov2_vitb14.pth",
    url="facebookresearch/dinov2:dinov2_vitb14",
    vit=_vit("vit_base", 14, 37, layerscale=True),
))
register(ZooEntry(
    "dinov2_vitb14_reg", "vit", "raw", "dinov2_vitb14_reg.pth",
    url="facebookresearch/dinov2:dinov2_vitb14_reg",
    vit=_vit("vit_base", 14, 37, layerscale=True, num_register_tokens=4),
))
register(ZooEntry(
    "dinov2_vitl14", "vit", "raw", "dinov2_vitl14.pth",
    url="facebookresearch/dinov2:dinov2_vitl14",
    vit=_vit("vit_large", 14, 37, layerscale=True),
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
register(ZooEntry(
    "deit3_vitb16", "vit", "state_dict", "deit_3_base_384_21k.pth",
    url="facebookresearch/deit:deit_3_base_384_21k",
    vit=_vit("vit_base", 16, 24, layerscale=True), default_size=384,
))
register(ZooEntry(
    "deit3_vitl16", "vit", "state_dict", "deit_3_large_384_21k.pth",
    url="facebookresearch/deit:deit_3_large_384_21k",
    vit=_vit("vit_large", 16, 24, layerscale=True), default_size=384,
))
# BEiT-v2 and MiDaS' BEiT-L/16: a per-block relative-position bias, so they
# run at the grid their tables were trained for; the reference wrappers
# resize every input to it (beit_v2.py:255-257, midas_final.py:46-52)
register(ZooEntry(
    "beitv2_vitb16", "vit", "state_dict", "beitv2_vitb16.pth",
    url="gdrive BEiT-v2 ViT-B/16 (beit_v2.py:8-13)",
    vit=_vit("vit_base", 16, pos_embed="none", rel_pos_bias=True, layerscale=True),
    fixed_input=224,
))
register(ZooEntry(
    "midas_l16", "vit", "state_dict", "dpt_beit_large_384.pt",
    url="intel-isl/MiDaS dpt_beit_large_384 (midas_final.py:83-87)",
    vit=_vit("vit_large", 16, pos_embed="none", rel_pos_bias=True, layerscale=True),
    prefix="pretrained.model.",
    default_size=384,
    fixed_input=384,
    fixed_input_mode="bicubic",
    image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
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

# --- SAM image encoders (reference sam.py; windowed-attention ViTDet) -----
for _arch, _file in [("vit_b", "sam_vit_b_01ec64.pth"),
                     ("vit_l", "sam_vit_l_0b3195.pth"),
                     ("vit_h", "sam_vit_h_4b8939.pth")]:
    register(ZooEntry(
        f"sam_{_arch}", "sam", "raw", _file,
        url=f"dl.fbaipublicfiles.com/segment_anything/{_file}",
        default_size=1024,
    ))

# --- ConvNeXt family (reference convnext.py) ------------------------------
register(ZooEntry(
    "cnxt_b_in22k", "convnext", "raw", "convnext_base_in22k.pth",
    url="timm convnext_base_in22k",
))
register(ZooEntry(
    "cnxt_b_fcmae", "convnext", "raw", "convnextv2_base_fcmae.pth",
    url="timm convnextv2_base.fcmae_ft_in22k_in1k_384",
))
register(ZooEntry(
    "cnxt_b_w_laion2b", "convnext", "openclip", "convnext_base_w_laion2b.pt",
    url="open_clip convnext_base_w laion2b_s13b_b82k",
    prefix="visual.trunk.",
    image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD,
))

# --- ResNet-50 SSL zoo (17 wrappers, template simclr.py:29-115) -----------
_R50 = [
    # (name, source, filename, url)
    ("simclr_resnet50", "vissl", "simclr_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl simclr_rn50_1000ep"),
    ("mocov2_resnet50", "mocov2", "mocov2_resnet50.pth.tar",
     "dl.fbaipublicfiles.com/moco mocov2 800ep"),
    ("simsiam_resnet50", "mocov2", "simsiam_resnet50.pth.tar",
     "dl.fbaipublicfiles.com/simsiam 100ep-256bs"),
    ("byol_resnet50", "state_dict", "byol_resnet50.pth.tar",
     "gdrive byol r50 (byol.py)"),
    ("barlowtwins_resnet50", "vissl", "barlowtwins_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl barlow_twins_32gpus_4node"),
    ("densecl_resnet50", "state_dict", "densecl_resnet50.pth",
     "mmselfsup densecl r50 imagenet 200ep"),
    ("swav_resnet50", "vissl", "swav_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl swav_in1k_rn50_800ep"),
    ("selav2_resnet50", "vissl", "selav2_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl sela-v2 400ep_2x224"),
    ("deepclusterv2_resnet50", "vissl", "deepclusterv2_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl deepclusterv2_800ep"),
    ("clusterfit_resnet50", "vissl", "clusterfit_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl clusterfit_16k_rotnet"),
    ("npid_resnet50", "vissl", "npid_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl npid_1crop_200ep"),
    ("npid_plusplus_resnet50", "vissl", "npid_plusplus_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl npid++ 4node_800ep"),
    ("pirl_resnet50", "vissl", "pirl_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl pirl_jigsaw_4node_800ep"),
    ("jigsaw_resnet50", "vissl", "jigsaw_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl jigsaw_rn50_in22k"),
    ("rotnet_resnet50", "vissl", "rotnet_resnet50.torch",
     "dl.fbaipublicfiles.com/vissl rotnet_rn50_in22k"),
    ("mocov3_resnet50", "mocov3", "mocov3_resnet50.pth.tar",
     "dl.fbaipublicfiles.com/moco-v3 r50 1000ep"),
    ("dino_resnet50", "raw", "dino_resnet50.pth",
     "facebookresearch/dino:dino_resnet50"),
]
for _name, _source, _file, _url in _R50:
    register(ZooEntry(_name, "resnet", _source, _file, url=_url, default_size=480))

# tiny randomly-initialized ViT for smoke tests
register(ZooEntry(
    "test_tiny_vit", "vit", "raw", "__never_exists__.pth",
    vit=dict(patch_size=8, width=32, depth=4, num_heads=2, mlp_ratio=2.0),
    default_size=64,
))


def checkpoint_dir() -> str:
    return os.environ.get("MVP_CHECKPOINT_DIR", "checkpoints")


def load_variables(entry: ZooEntry, cfg) -> tuple[dict | None, dict]:
    """The entry's checkpoint under ``checkpoint_dir()``, converted: a
    numpy tree in the JAX package's ``ViT``, ``SAMViT``, ``ConvNeXt`` or
    ``ResNet50`` layout (None when no file is there) and the converter's
    extras (RADIO's input-conditioner ``image_mean``/``image_std``).
    ``cfg``: the architecture's config (``ViTConfig``, ``SAMViTConfig``,
    ``ConvNeXtConfig``; None for ResNet-50)."""
    path = os.path.join(checkpoint_dir(), entry.filename)
    if not os.path.exists(path):
        return None, {}
    if entry.arch not in ("vit", "sam", "convnext", "resnet"):
        raise NotImplementedError(
            f"no loader for {entry.name}'s architecture {entry.arch!r} (the zoo "
            "loads vit, sam, convnext and resnet entries; the SD featurizers "
            "load their own files)")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = unwrap_checkpoint(ckpt, entry.source)
    if entry.arch == "resnet":
        return convert_resnet50(sd, prefix=entry.prefix), {}
    if entry.arch == "sam":
        return convert_sam(sd, cfg, prefix=entry.prefix or "image_encoder."), {}
    if entry.arch == "convnext":
        return convert_convnext(sd, cfg, prefix=entry.prefix), {}
    if entry.converter == "hf":
        return convert_vit_hf(sd, cfg, prefix=entry.prefix), {}
    if entry.converter == "radio":
        return convert_radio(sd, cfg, prefix=entry.prefix)
    if entry.converter == "openclip":
        return convert_vit_openclip(sd, cfg, prefix=entry.prefix or "visual."), {}
    return convert_vit_timm(sd, cfg, prefix=entry.prefix), {}


_INITS = {ViT: init_vit_, ResNet50: init_resnet_, vit_sam.SAMViT: vit_sam.init_sam_,
          convnext_mod.ConvNeXt: convnext_mod.init_convnext_}


def random_init(module, seed: int = 0):
    """Seeded random init of a ViT, SAM encoder, ConvNeXt or ResNet-50
    (flax-default distributions)."""
    return _INITS[type(module)](module, torch.Generator().manual_seed(seed))


def _cast(module: torch.nn.Module, device, dtype, keep_f32=(), channels_last=False):
    """``module`` on ``device`` in ``dtype``, but the parameters named in
    ``keep_f32`` stay float32, as the JAX package keeps them."""
    kw = {"memory_format": torch.channels_last} if channels_last else {}
    module = module.to(device=device, **kw)
    dtype = resolve_dtype(dtype)
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] not in keep_f32:
            p.data = p.data.to(dtype)
    return module


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
    if (cfg.pos_embed == "learned" or cfg.rel_pos_bias) and cfg.table_grid is None:
        # pin the canonical pos-embed grid to the init resolution so inputs
        # of any other size resize the table instead of re-shaping the param
        # (a relative-position bias table is built for that grid too);
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


def build_resnet_extractor(
    name: str,
    output: str = "dense",
    return_layers=None,
    return_multilayer: bool = False,
    add_norm: bool = False,
    return_cls: bool = False,
    dtype=None,
    device=None,
) -> FeatureExtractor:
    """Frozen ResNet-50 extractor for zoo entry ``name``: taps
    ``return_layers`` (default all five), ``feat_dim`` as ``(C, hw)`` pairs
    (``RESNET50_FEAT_DIMS``), ``patch_size`` 0, on ``device`` (default
    cuda; raises without a card unless a device is given) in ``dtype``."""
    entry = ZOO[name]
    device = resolve_device(device)
    return_layers = list(return_layers) if return_layers is not None else [0, 1, 2, 3, 4]
    feat_dims = [RESNET50_FEAT_DIMS[i] for i in return_layers]
    multilayers = return_layers if return_multilayer else [return_layers[-1]]
    spec = FeatureSpec(
        feat_dim=feat_dims if return_multilayer else feat_dims[-1],
        patch_size=0,
        multilayers=tuple(multilayers),
        arch="resnet",
        checkpoint_name=f"{name}_{output}_{return_layers}",
        output=output,
        num_layers=5,
        add_norm=add_norm,
        image_mean=entry.image_mean,
        image_std=entry.image_std,
    )
    variables, _ = load_variables(entry, None)
    module = ResNet50()
    if variables is None:
        log.warning("no checkpoint for %s under %s — random init", name, checkpoint_dir())
        module = random_init(module)
    else:
        module.load_state_dict(resnet_state_dict(variables), strict=True)
    # cuDNN's convolutions read NHWC (channels-last) memory, which the input is
    module = module.to(device=device, dtype=resolve_dtype(dtype),
                       memory_format=torch.channels_last)
    return FeatureExtractor(make_resnet_feature_fn(module, multilayers), module, spec,
                            return_multilayer=return_multilayer, return_cls=return_cls)


def build_sam_extractor(
    name: str,
    output: str = "dense",
    layer: int = -1,
    return_multilayer: bool = False,
    add_norm: bool = False,
    return_cls: bool = False,
    dtype=None,
    checkpoint_name: str | None = None,  # config-surface nicety; ignored
    device=None,
) -> FeatureExtractor:
    """Frozen SAM image encoder for zoo entry ``name`` (``sam_vit_{b,l,h}``):
    taps at ``default_vit_multilayers(depth)``, float32 (B, h, w, C) maps
    (``gap``: their spatial mean), no cls token, on ``device`` (default
    cuda; raises without a card unless a device is given) in ``dtype``."""
    entry = ZOO[name]
    device = resolve_device(device)
    cfg = vit_sam.SAMViTConfig(**vit_sam.SAM_PRESETS[name.replace("sam_", "")])
    multilayers = default_vit_multilayers(cfg.depth)
    if not return_multilayer:
        multilayers = [multilayers[-1] if layer == -1 else layer]
    spec = FeatureSpec(
        feat_dim=[cfg.width] * len(multilayers) if return_multilayer else cfg.width,
        patch_size=cfg.patch_size,
        multilayers=tuple(multilayers),
        arch="sam",
        checkpoint_name=name,
        output=output,
        num_layers=cfg.depth,
        add_norm=add_norm,
        image_mean=entry.image_mean,
        image_std=entry.image_std,
    )
    variables, _ = load_variables(entry, cfg)
    module = vit_sam.SAMViT(cfg)
    if variables is None:
        log.warning("no checkpoint for %s under %s — random init", name, checkpoint_dir())
        module = random_init(module)
    else:
        module.load_state_dict(sam_state_dict(variables), strict=True)
    module = _cast(module, device, dtype, keep_f32=vit_sam.KEEP_F32)
    taps = tuple(multilayers)

    def apply_fn(images: torch.Tensor):
        maps = [m.float() for m in module(images, taps=taps)["maps"]]
        if output == "gap":
            maps = [m.mean(dim=(1, 2)) for m in maps]
        return maps, [None] * len(maps)

    return FeatureExtractor(apply_fn, module, spec, return_multilayer=return_multilayer,
                            return_cls=return_cls)


def build_convnext_extractor(
    name: str,
    output: str = "dense",
    layer: int = -1,
    return_multilayer: bool = False,
    add_norm: bool = False,
    return_cls: bool = False,
    dtype=None,
    use_grn: bool | None = None,
    checkpoint_name: str | None = None,  # config-surface nicety; ignored
    device=None,
) -> FeatureExtractor:
    """Frozen ConvNeXt-B for zoo entry ``name``: stage taps; ``dense``
    resizes every stage map in float32 to the /16 grid (bilinear, no
    antialias; reference ``convnext.py:99-105``), ``gap`` takes their
    spatial mean, ``raw`` keeps the stage resolutions. GRN (ConvNeXt-v2)
    unless ``use_grn`` says otherwise when ``"fcmae"`` is in the name. On
    ``device`` (default cuda; raises without a card unless a device is
    given) in ``dtype``."""
    entry = ZOO[name]
    device = resolve_device(device)
    grn = use_grn if use_grn is not None else ("fcmae" in name)
    cfg = convnext_mod.ConvNeXtConfig(use_grn=grn)
    multilayers = [0, 1, 2, 3]
    if not return_multilayer:
        multilayers = [multilayers[-1] if layer == -1 else layer]
    spec = FeatureSpec(
        feat_dim=([cfg.dims[i] for i in multilayers] if return_multilayer
                  else cfg.dims[multilayers[-1]]),
        patch_size=16,
        multilayers=tuple(multilayers),
        arch="convnext",
        checkpoint_name=name,
        output=output,
        num_layers=4,
        add_norm=add_norm,
        image_mean=entry.image_mean,
        image_std=entry.image_std,
    )
    variables, _ = load_variables(entry, cfg)
    module = convnext_mod.ConvNeXt(cfg)
    if variables is None:
        log.warning("no checkpoint for %s under %s — random init", name, checkpoint_dir())
        module = random_init(module)
    else:
        module.load_state_dict(convnext_state_dict(variables), strict=True)
    # cuDNN's convolutions read NHWC (channels-last) memory, which the
    # activations are
    module = _cast(module, device, dtype, keep_f32=convnext_mod.KEEP_F32,
                   channels_last=True)
    taps = tuple(multilayers)

    def apply_fn(images: torch.Tensor):
        maps = module(images, taps=taps)
        if output == "dense":
            out_hw = (images.shape[1] // 16, images.shape[2] // 16)
            maps = [resize(m.float(), out_hw, mode="bilinear") for m in maps]
        elif output == "gap":
            maps = [m.mean(dim=(1, 2)) for m in maps]
        return maps, [None] * len(maps)

    return FeatureExtractor(apply_fn, module, spec, return_multilayer=return_multilayer,
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
    dinov2 hubs)."""
    name = checkpoint_name or f"{dino_name}_{model_name}"
    name = {"dinov2_b14": "dinov2_vitb14"}.get(name, name)
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


BEiTV2 = _simple_vit_wrapper("beitv2_vitb16")


def DeIT(model_size="base", img_size=384, output="dense", layer=-1,
         return_multilayer=False, add_norm=False, return_cls=False, **kw):
    """Reference ``deit.py`` (DeiT-III at 384)."""
    name = "deit3_vitb16" if model_size == "base" else "deit3_vitl16"
    return build_vit_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, return_cls=return_cls, **_clean(kw))


def make_beit_backbone(output="dense", layer=-1, midas=True,
                       return_multilayer=False, add_norm=False, **kw):
    """Reference ``midas_final.py:83-119`` (MiDaS DPT-BEiT-L/16-384 trunk)."""
    kw.pop("return_cls", None)
    return build_vit_extractor(
        "midas_l16", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm, **_clean(kw))


# config-surface spellings that differ from the ZOO registry keys
# (configs/backbone/{deepcluster-v2,sela-v2}_resnet50.yaml)
_RESNET_NAME_ALIASES = {
    "deepcluster_v2_resnet50": "deepclusterv2_resnet50",
    "sela_v2_resnet50": "selav2_resnet50",
}


def _resnet_wrapper(zoo_name: str):
    def ctor(arch="resnet50", return_layers=None, output="dense",
             return_multilayer=False, add_norm=False, return_cls=False,
             checkpoint_name=None, **kw):
        kw.pop("dino_name", None)
        kw.pop("model_name", None)
        _clean(kw)
        # a backbone YAML's checkpoint_name can retarget the wrapper, as
        # DINO's does; a name that is no entry raises rather than train on
        # another backbone's features
        name = _RESNET_NAME_ALIASES.get(checkpoint_name, checkpoint_name) or zoo_name
        if name not in ZOO:
            raise KeyError(
                f"checkpoint_name={checkpoint_name!r} is not a zoo entry "
                f"(wrapper default {zoo_name!r}); known resnet entries: "
                + ", ".join(k for k in ZOO if "resnet" in k))
        return build_resnet_extractor(
            name, output=output, return_layers=return_layers,
            return_multilayer=return_multilayer, add_norm=add_norm,
            return_cls=return_cls, **kw)

    return ctor


SIMCLR = _resnet_wrapper("simclr_resnet50")
MOCOV2 = _resnet_wrapper("mocov2_resnet50")
SIMSIAM = _resnet_wrapper("simsiam_resnet50")
BYOL = _resnet_wrapper("byol_resnet50")
BARLOWTWINS = _resnet_wrapper("barlowtwins_resnet50")
DENSECL = _resnet_wrapper("densecl_resnet50")
SWAV = _resnet_wrapper("swav_resnet50")
SELAV2 = _resnet_wrapper("selav2_resnet50")
DEEPCLUSTERV2 = _resnet_wrapper("deepclusterv2_resnet50")
CLUSTERFIT = _resnet_wrapper("clusterfit_resnet50")
NPID = _resnet_wrapper("npid_resnet50")
NPID_PLUSPLUS = _resnet_wrapper("npid_plusplus_resnet50")
PIRL = _resnet_wrapper("pirl_resnet50")
JIGSAW = _resnet_wrapper("jigsaw_resnet50")
ROTNET = _resnet_wrapper("rotnet_resnet50")
MoCoV3_RES = _resnet_wrapper("mocov3_resnet50")
DINO_RESNET = _resnet_wrapper("dino_resnet50")


def SAM(arch="vit_b", output="dense", layer=-1, return_multilayer=False,
        add_norm=False, **kw):
    """Reference ``sam.py:11-113`` constructor surface."""
    kw.pop("return_cls", None)
    return build_sam_extractor(
        f"sam_{arch}", output=output, layer=layer,
        return_multilayer=return_multilayer, add_norm=add_norm, **_clean(kw))


def ConvNext(arch="convnext_base", checkpoint="in22k", output="dense",
             layer=-1, return_multilayer=False, add_norm=False, **kw):
    """Reference ``convnext.py`` constructor surface: both open_clip laion2b
    checkpoints (``clip_convnext``, ``clip_convnext_augreg``) map to
    ``cnxt_b_w_laion2b``, as in the JAX zoo."""
    name = {
        "in22k": "cnxt_b_in22k",
        "fcmae_ft_in22k_in1k_384": "cnxt_b_fcmae",
    }.get(checkpoint, "cnxt_b_w_laion2b" if "laion" in str(checkpoint)
          else "cnxt_b_in22k")
    kw.pop("return_cls", None)
    return build_convnext_extractor(
        name, output=output, layer=layer, return_multilayer=return_multilayer,
        add_norm=add_norm, **_clean(kw))


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


def DIFT(model_id="stabilityai/stable-diffusion-2-1", time_step=1, layer=1, output="dense",
         return_multilayer=False, add_norm=False, device=None, **kw):
    """Reference ``stablediffusion.py`` / ``dift_sd.py``: the one-step noised
    SD-2.1 UNet's up-block features (``models/sd/``). Weights:
    ``$MVP_CHECKPOINT_DIR/sd21/{unet,vae,text_encoder}.bin``. float32
    whatever ``dtype`` a driver passes."""
    from midvision_probe_torch.models.sd.featurizer import DIFT as _DIFT

    return _DIFT(model_id=model_id, time_step=time_step, output=output, layer=layer,
                 return_multilayer=return_multilayer, add_norm=add_norm, device=device)


def Zero123(time_step=1, output="dense", layer=1, return_multilayer=False, add_norm=False,
            device=None, **kw):
    """Reference ``zero123.py``: the CLIP-image-conditioned LDM UNet's
    guidance-combined up-block features. Weights:
    ``$MVP_CHECKPOINT_DIR/zero123/105000.ckpt``."""
    from midvision_probe_torch.models.sd.featurizer import Zero123 as _Z

    return _Z(time_step=time_step, output=output, layer=layer,
              return_multilayer=return_multilayer, add_norm=add_norm, device=device)
