"""PyTorch/CUDA port of the probing harness.

Mirrors the JAX package's layout (``config``, ``datasets``, ``ops``,
``models``, ``engine``, ``utils``) so each module's counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` on
first use. Entry points run on ``cuda`` unless the caller passes a CPU
device explicitly; they never fall back to the CPU on their own.
"""
