"""Fault-plane error hierarchy.

Import-light on purpose: ``repro_torch.serving.engine`` and the
``repro_torch.api`` backends raise these, so this module must not import
anything from those packages (or torch) to stay cycle-free.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for injected-fault and overload signals."""


class ShardCrashed(FaultError):
    """The shard's control plane is gone: injects and probes both fail."""

    def __init__(self, shard: str, msg: str | None = None):
        super().__init__(msg or f"shard {shard!r} crashed")
        self.shard = shard


class ShardHung(FaultError):
    """The shard accepts nothing and makes no progress, but is not dead.

    Probes time out (raised from ``capacity()``) exactly like a crash —
    callers cannot distinguish a hang from a crash, which is the point.
    """

    def __init__(self, shard: str, msg: str | None = None):
        super().__init__(msg or f"shard {shard!r} is hung")
        self.shard = shard


class NTKernelFault(FaultError):
    """An NT kernel raised while processing a packet/batch."""

    def __init__(self, nt: str, dag_uid: int | None = None):
        super().__init__(f"NT kernel {nt!r} faulted"
                         + (f" (dag {dag_uid})" if dag_uid is not None else ""))
        self.nt = nt
        self.dag_uid = dag_uid


class Overloaded(FaultError):
    """Admission rejected: the substrate is over capacity.

    Carries a ``retry_after_s`` hint so callers back off instead of
    hammering a saturated engine (the serving tier's answer to "reject,
    don't stall every tenant").
    """

    def __init__(self, retry_after_s: float, msg: str = "over capacity"):
        super().__init__(f"{msg}; retry after {retry_after_s:.3f}s")
        self.retry_after_s = float(retry_after_s)
