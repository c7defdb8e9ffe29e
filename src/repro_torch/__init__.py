"""PyTorch/CUDA port of the Polynesia HTAP reproduction.

Same layout and public names as the JAX package it is held against
(``repro``): ``repro_torch.core`` is the system (row store, shipping,
update application, consistency, analytical engine, session), and
``repro_torch.kernels`` holds the hand-written Hopper kernels (CUDA C++
under ``kernels/csrc``) with a plain PyTorch version beside each.

The package imports ``torch`` and ``numpy`` only. Entry points take an
explicit ``device``; ``device=None`` means the GPU and raises when there
is none.
"""

__version__ = "0.1.0"
