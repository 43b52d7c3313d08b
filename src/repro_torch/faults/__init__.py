"""Fault-plane error classes (a copy of the JAX package's
``faults/errors.py``).

Only the error hierarchy is ported so far: ``Engine.submit`` raises
:class:`Overloaded`.  The fault plan, state and injector belong to the
fleet layers (ROADMAP Queue 1).
"""
from .errors import (FaultError, NTKernelFault, Overloaded, ShardCrashed,
                     ShardHung)

__all__ = ["FaultError", "ShardCrashed", "ShardHung", "NTKernelFault",
           "Overloaded"]
