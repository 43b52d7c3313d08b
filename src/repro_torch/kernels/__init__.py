"""Hand-written CUDA kernels of the port, one package per kernel: the CUDA
wrapper and its plain PyTorch version (``kernel.py``), the user-facing ops
(``ops.py``) and, where the JAX package has one, the reference
(``ref.py``).  Sources live in ``repro_torch/csrc``; ``_build`` compiles
them at the first CUDA use."""
