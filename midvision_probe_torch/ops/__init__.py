"""Tensor ops of the PyTorch port: resampling, activations, the fused
upsample-conv fold, and the hand-written CUDA attention kernel."""
