"""Backbones, the feature contract and probe heads of the PyTorch port."""
