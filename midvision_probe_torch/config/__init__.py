"""Hydra-compatible config layer of the PyTorch port (see ``core``)."""

from midvision_probe_torch.config.core import (  # noqa: F401
    Config,
    compose,
    instantiate,
    main,
)
