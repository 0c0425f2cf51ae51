"""Losses, optimizer, metrics, logging and device helpers of the PyTorch port."""
