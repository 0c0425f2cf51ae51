"""The uniform frozen-feature contract (counterpart of the JAX package's
``models/feature_extractor.py``).

* ``FeatureSpec``: static metadata that probes need to build heads,
* ``FeatureExtractor``: a frozen backbone module plus its feature function,
* ``tokens_to_output``: token -> map conversion (NHWC for dense modes).

As in the JAX package, the optional per-tap BatchNorm (``add_norm``) trains
with the probe and lives probe-side (``models/probes.py::TapNorms``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.nn as nn

from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.utils.profiling import span

# the output modes of the feature contract
OUTPUTS = ("cls", "gap", "dense", "dense-cls")


def tokens_to_output(output_type: str, dense_tokens: torch.Tensor,
                     cls_token: torch.Tensor | None,
                     feat_hw: tuple[int, int]) -> torch.Tensor:
    """(B, h*w, C) tokens -> requested output (NHWC for dense modes)."""
    h, w = feat_hw
    B, _, C = dense_tokens.shape
    if output_type == "cls":
        if cls_token is None:
            raise ValueError("output 'cls' needs a cls token")
        return cls_token
    if output_type == "gap":
        return dense_tokens.mean(dim=1)
    if output_type == "dense":
        return dense_tokens.reshape(B, h, w, C)
    if output_type == "dense-cls":
        if cls_token is None:
            raise ValueError("output 'dense-cls' needs a cls token")
        dense = dense_tokens.reshape(B, h, w, C)
        cls = cls_token[:, None, None, :].expand(B, h, w, C)
        return torch.cat([dense, cls], dim=-1)
    raise ValueError(f"unknown output type {output_type!r}")


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Static backbone metadata (the reference's wrapper attributes)."""

    feat_dim: Any  # int, or list[int]
    patch_size: int
    multilayers: tuple[int, ...]
    arch: str
    checkpoint_name: str
    output: str
    num_layers: int
    add_norm: bool = False
    image_mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: tuple[float, float, float] = (0.229, 0.224, 0.225)

    @property
    def layer(self) -> str:
        return "-".join(str(x) for x in self.multilayers)


def default_vit_multilayers(num_layers: int) -> list[int]:
    """The canonical 4-tap schedule (reference ``dino.py:51-57``)."""
    return [
        num_layers // 4 - 1,
        num_layers // 2 - 1,
        num_layers // 4 * 3 - 1,
        num_layers - 1,
    ]


def make_vit_feature_fn(module: nn.Module, taps: Sequence[int], output: str,
                        num_prefix_tokens: int, fixed_input: int | None = None,
                        fixed_input_mode: str = "bilinear") -> Callable:
    """Build ``images -> (list[map], list[cls])`` for a ViT module.

    ``fixed_input``: the reference wrapper of some models (CroCo, BEiT,
    MiDaS) resizes every input to ``fixed_input`` squared
    (``fixed_input_mode``, ``align_corners=False``), so features come out at
    that fixed grid whatever the input size."""
    taps = tuple(taps)

    def fit_input(images: torch.Tensor) -> torch.Tensor:
        if fixed_input is not None and tuple(images.shape[1:3]) != (fixed_input,
                                                                    fixed_input):
            images = resize(images, (fixed_input, fixed_input), mode=fixed_input_mode,
                            align_corners=False)
        return images

    def apply_fn(images: torch.Tensor):
        res = module(fit_input(images), taps=taps)
        gh, gw = res["grid_hw"]
        num_spatial = gh * gw
        maps, clss = [], []
        for tokens in res["tokens"]:
            cls_tok = tokens[:, 0] if num_prefix_tokens > 0 else None
            spatial = tokens[:, -num_spatial:]
            maps.append(tokens_to_output(output, spatial, cls_tok, (gh, gw)))
            clss.append(cls_tok)
        return maps, clss

    def qkv_fn(images: torch.Tensor):
        """The last tapped block's (B, N, 3, H, d) qkv projection, the q, k
        and v before any RoPE, and the patch grid, from one forward: a hook
        on that block's ``attn.qkv`` keeps its output (JAX's ``sow``)."""
        attn = module.blocks[max(taps)].attn
        seen = []
        hook = attn.qkv.register_forward_hook(lambda _m, _i, out: seen.append(out))
        try:
            res = module(fit_input(images), taps=taps)
        finally:
            hook.remove()
        B, N, _ = seen[0].shape
        return seen[0].reshape(B, N, 3, attn.cfg.num_heads, attn.cfg.head_dim), res["grid_hw"]

    apply_fn.qkv_fn = qkv_fn  # for FeatureExtractor.extract_kqv
    return apply_fn


def make_resnet_feature_fn(module: nn.Module, taps: Sequence[int]) -> Callable:
    """Build ``images -> (list[NHWC map], list[None])`` for the ResNet
    trunk. CNN maps are already spatial and have no cls token; callers
    that want another ``output`` pool them."""
    taps = tuple(taps)

    def apply_fn(images: torch.Tensor):
        maps = module(images, taps=taps)
        return maps, [None] * len(maps)

    return apply_fn


class FeatureExtractor:
    """A frozen backbone: ``module`` (an ``nn.Module`` whose parameters do
    not train) and ``apply_fn`` (images NHWC -> (maps, cls tokens)).

    A call follows grad mode, as the JAX ``FeatureExtractor`` stops no
    gradient: images that require grad get the gradient of the features
    with respect to them (through the attention kernels' backwards on a
    card); on images that do not, nothing is recorded, since no parameter
    requires grad. The probe trainers run the backbone under their own
    ``torch.no_grad()``.

    ``forward_count`` (class-wide) counts backbone forwards, so a run can
    check that every forward went through the attention kernel."""

    forward_count = 0

    def __init__(self, apply_fn: Callable, module: nn.Module, spec: FeatureSpec,
                 return_multilayer: bool = False, return_cls: bool = False):
        self._apply_fn = apply_fn
        self.module = module.eval().requires_grad_(False)
        self.spec = spec
        self.return_multilayer = return_multilayer
        self.return_cls = return_cls
        self.arch = spec.arch
        self.patch_size = spec.patch_size
        self.checkpoint_name = spec.checkpoint_name
        self.output = spec.output
        self.multilayers = list(spec.multilayers)
        self.layer = spec.layer
        # a ResNet's feat_dim is a (C, hw) pair per tap, and its last pair
        # alone without multilayer
        self.feat_dim = spec.feat_dim if return_multilayer else (
            spec.feat_dim[-1] if isinstance(spec.feat_dim, (list, tuple))
            and spec.arch != "resnet" else spec.feat_dim)

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def outputs(self, images: torch.Tensor):
        """images NHWC -> (feature maps, cls tokens), one of each per tap (a
        cls token is None without one); one counted forward."""
        FeatureExtractor.forward_count += 1
        with span("mvp.backbone"):
            return self._apply_fn(images.to(self.device))

    def __call__(self, images: torch.Tensor):
        """images NHWC (normalized) -> feature map(s) per the contract."""
        maps, cls_tokens = self.outputs(images)
        if self.return_cls and len(maps) == 1 and cls_tokens[0] is not None:
            return cls_tokens[0]
        return maps if self.return_multilayer else maps[-1]

    def features(self, images: torch.Tensor) -> list[torch.Tensor]:
        """Always-multilayer call used by probe training."""
        return self.outputs(images)[0]

    def extract_kqv(self, images: torch.Tensor, mode: str = "k") -> torch.Tensor:
        """Dense features from the last tapped block's attention (reference
        ``return_kqv`` / ``extract_kqv``, ``dino.py:82-138``): its q, k or v
        as (B, h, w, C) patch maps, or (B, h, w, 3C) for ``"kqv"`` (k, q, v
        in that order). The projection is the one the block's attention ran
        on (K1's input on the fused branch); one counted forward that
        follows grad mode, as the JAX ``extract_kqv`` stops no gradient. ViT
        extractors only."""
        qkv_fn = getattr(self._apply_fn, "qkv_fn", None)
        if self.arch != "vit" or qkv_fn is None:
            raise ValueError(f"kqv extraction is a ViT feature, not one of {self.arch!r}")
        if mode not in ("k", "q", "v", "kqv"):
            raise ValueError(f"mode must be one of k, q, v, kqv; got {mode!r}")
        FeatureExtractor.forward_count += 1
        qkv, (gh, gw) = qkv_fn(images.to(self.device))
        B, N, _, H, d = qkv.shape

        def to_map(role: int) -> torch.Tensor:  # patch tokens only
            t = qkv[:, :, role].reshape(B, N, H * d)
            return t[:, -gh * gw:].reshape(B, gh, gw, H * d)

        if mode == "kqv":
            return torch.cat([to_map(1), to_map(0), to_map(2)], dim=-1)
        return to_map("qkv".index(mode))
