"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Mirrors ``src/repro/`` module for module.  Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (``repro_torch/kernels/csrc``), built at first use.  Layers keep the
reference's parameter keys and layouts, so a flattened JAX parameter tree is
the port's state dict.  This package imports neither ``jax`` nor ``repro``.
"""
