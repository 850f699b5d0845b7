"""PreSto on PyTorch and CUDA: the port of the ``repro`` package.

The same Transform, data and produce path as ``repro``, with the Pallas TPU
kernels replaced by hand-written CUDA kernels for Hopper
(``repro_torch.kernels``).  Imports torch and numpy, never jax and nothing
of ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
