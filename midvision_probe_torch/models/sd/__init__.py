"""Stable-Diffusion feature stack of the PyTorch port (counterpart of the
JAX package's ``models/sd/``): VAE encoder -> DDPM one-step noising ->
UNet with up-block feature taps, conditioned on CLIP text embeddings
(DIFT) or on a CLIP image embedding (Zero123); ``featurizer.py`` holds
the featurizers, ``convert.py`` the checkpoint converters and
``tokenizer.py`` the CLIP BPE tokenizer."""

from midvision_probe_torch.models.sd.text_encoder import (  # noqa: F401
    CLIPTextConfig,
    CLIPTextEncoder,
)
from midvision_probe_torch.models.sd.unet import UNet2DCondition, UNetConfig  # noqa: F401
from midvision_probe_torch.models.sd.vae import VAEEncoder, VAEEncoderConfig  # noqa: F401
