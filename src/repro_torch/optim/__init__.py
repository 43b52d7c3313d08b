"""Optimizer and gradient compression: the JAX package's ``optim``."""
from . import adamw, compress  # noqa: F401
