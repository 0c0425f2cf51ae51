"""Evaluation cores of the PyTorch port."""
