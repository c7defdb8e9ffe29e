"""Hand-written Hopper kernels of the port, one sub-package per unit.

Each unit has an ``ops.py`` with the public wrappers and, beside every
kernel, a plain PyTorch version (``*_ref``) of the same function. A wrapper
launches its CUDA kernel for a tensor that lies on the GPU and takes the
plain version only for a tensor that lies on the CPU. The CUDA sources are
under ``csrc/`` and are built at first use (``build.py``).
"""
