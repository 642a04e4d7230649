"""SkyMemory's paged serving system on PyTorch and CUDA (Hopper).

The port of ``repro`` (JAX/Pallas, TPU), package by package: ``models``
(the dense GQA decoder), ``kernels`` (hand-written ``sm_90a`` attention
kernels beside their plain PyTorch versions), ``serving`` (the paged
engine) and ``core`` (the KVC payload format).  It imports neither JAX nor
``repro``.
"""
