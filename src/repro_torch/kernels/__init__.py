"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of
``repro.kernels``: ``ref.py`` holds the plain PyTorch version, ``ops.py``
the wrapper (plain version for CPU tensors, the kernel for CUDA tensors),
and the sources live in ``repro_torch/csrc/``."""
