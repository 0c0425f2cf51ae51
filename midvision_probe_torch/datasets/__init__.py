"""Datasets + loader builder of the PyTorch port.

Items are dicts of channel-last numpy arrays (image (H, W, 3) float32,
depth (H, W, 1), snorm (H, W, 3), segmentation (H, W) int32), the same
layout as the JAX package's datasets. Pair datasets (NAVI, ScanNet) carry
each key once per view with a ``_0`` / ``_1`` suffix.
"""

from midvision_probe_torch.datasets.builder import Loader, build_loader  # noqa: F401
