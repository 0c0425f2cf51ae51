"""PyTorch state_dict → parameter-tree conversion (copy of the jax-free
converters of the JAX package's ``models/convert/``).

The converters emit numpy trees in the JAX package's ``ViT`` layout, array
for array the same; the zoo maps a tree onto the port's ``ViT`` through
``convert.from_jax.vit_state_dict``, so one tested mapping carries weights
into the port whether they come from JAX or from a file.

* ``unwrap_checkpoint`` — digs the trunk out of a source's container
  (raw, state_dict, vissl, mocov2, mocov3, mmselfsup, croco, openclip),
* ``convert_vit_timm`` — timm/DINO/iBOT/DeiT-layout ViTs (fused qkv),
* ``convert_vit_hf``   — HuggingFace ViT/ViTMAE layout (split q/k/v),
* ``convert_radio``    — NVIDIA RADIO, with its input conditioner's
  mean and std,
* ``convert_vit_openclip`` — open_clip / OpenAI CLIP visual towers,
* ``convert_resnet50`` — torchvision-layout ResNet-50 trunks, to the JAX
  ``ResNet50`` layout (``convert.from_jax.resnet_state_dict`` maps it),
* ``convert_convnext`` — timm, FB and open_clip ConvNeXt trunks, to the
  JAX ``ConvNeXt`` layout (``convert.from_jax.convnext_state_dict``),
* ``convert_sam`` — segment_anything image encoders, to the JAX
  ``SAMViT`` layout (``convert.from_jax.sam_state_dict``).
"""

from midvision_probe_torch.models.convert.clip_convert import convert_vit_openclip  # noqa: F401
from midvision_probe_torch.models.convert.convnext_convert import convert_convnext  # noqa: F401
from midvision_probe_torch.models.convert.radio_convert import convert_radio  # noqa: F401
from midvision_probe_torch.models.convert.resnet_convert import convert_resnet50  # noqa: F401
from midvision_probe_torch.models.convert.sam_convert import convert_sam  # noqa: F401
from midvision_probe_torch.models.convert.remap import (  # noqa: F401
    MMSELFSUP_VIT_RENAME,
    prepare_state_dict,
    unwrap_checkpoint,
)
from midvision_probe_torch.models.convert.vit_convert import (  # noqa: F401
    convert_vit_hf,
    convert_vit_timm,
)
