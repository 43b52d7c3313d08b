"""Atomic, async checkpoints: the JAX package's ``checkpoint``."""
from .manager import CheckpointManager  # noqa: F401
