"""Laminar on PyTorch + CUDA: the port of the ``repro`` JAX package.

Imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``. The
hot-path ops run hand-written Hopper kernels on CUDA tensors (built from
``csrc/`` at first use) and their plain PyTorch versions on CPU tensors.
"""

__version__ = "0.1.0"
