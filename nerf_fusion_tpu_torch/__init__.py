"""PyTorch/CUDA port of the online RGB-D implicit fusion system.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy only, and keeps its own copies of every helper it needs.  The hot
kernels of the fusion loop (decoder and encoder MLPs, windowed point
stencils) are hand-written CUDA for Hopper under ``csrc/``, built with
``nvcc`` on first use; each has a plain PyTorch version beside it that
CPU tensors take.
"""

__version__ = "0.1.0"
