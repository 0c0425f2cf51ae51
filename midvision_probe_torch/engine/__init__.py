"""Probe-training engine, checkpoints and shared driver plumbing of the
PyTorch port."""
