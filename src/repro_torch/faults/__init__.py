"""Seeded, deterministic fault injection for the multi-tenant fleet (the
port of the JAX package's ``repro.faults``).

Usage::

    from repro_torch.faults import FaultPlan
    plan = FaultPlan(seed=7).crash(shard=2, epoch=40)
    sb = ShardedBackend(shards, fault_plan=plan)

Every backend honors an attached
:class:`~repro_torch.faults.state.FaultState` (crash/hang/degrade/
nt-exception/drop/corrupt); ``ShardedBackend`` turns probe misses into
failover.
"""
from .errors import (FaultError, NTKernelFault, Overloaded, ShardCrashed,
                     ShardHung)
from .injector import FaultInjector, faults_of
from .plan import FaultEvent, FaultPlan
from .state import FaultState

__all__ = [
    "FaultError", "ShardCrashed", "ShardHung", "NTKernelFault", "Overloaded",
    "FaultEvent", "FaultPlan", "FaultState", "FaultInjector", "faults_of",
]
