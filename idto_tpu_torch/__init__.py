"""PyTorch/CUDA port of ``idto_tpu``: contact-implicit trajectory
optimization by inverse dynamics, with the scenario-batched Gauss-Newton
trust-region solve running on an NVIDIA GPU.

The module tree mirrors ``idto_tpu`` so each counterpart sits at the same
relative path.  This package imports torch, numpy and the standard library
only; ``idto_tpu`` (JAX) is the reference it is tested against.  The one
hand-written device kernel is the block cyclic-reduction solve
(``ops/cr_kernel.py`` + ``csrc/cr_solve.cu``).
"""
