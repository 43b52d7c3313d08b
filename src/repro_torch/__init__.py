"""repro_torch — the PyTorch/CUDA port of the SuperNIC reproduction.

It mirrors the JAX package ``repro`` module for module; each counterpart
sits at the same relative path.  It imports ``torch`` and never ``jax`` or
``repro``.  Entry points run on the card (``cuda:0``) unless the caller
passes ``device="cpu"``; the hand-written CUDA kernels live in ``csrc/``
and are built at the first CUDA use (:mod:`repro_torch.kernels._build`).
"""
