"""FaultPlan: a seeded, deterministic schedule of faults.

A plan is a list of :class:`FaultEvent` records keyed by *global epoch*
(the fleet coordinator's epoch counter, not wall time), so the same plan
against the same seeded workload reproduces the identical run — the
resilience bench asserts this by fingerprinting two runs of one plan.

Builder methods chain::

    plan = (FaultPlan(seed=7)
            .crash(shard=2, epoch=40)
            .degrade(shard=0, epoch=10, factor=0.5, duration=20)
            .drop(shard=1, epoch=5, prob=0.01)
            .remove_tenant("b", epoch=30))
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field

KINDS = (
    "crash",        # shard dies: injects raise, run() freezes, probes fail
    "hang",         # shard wedges: same externally, but recoverable state
    "recover",      # undo crash/hang: shard comes back empty-handed
    "degrade",      # capacity *= factor for `duration` epochs (None=forever)
    "nt_exception", # NT kernel `nt` raises on inject for dags that use it
    "drop",         # inject dropped with prob before reaching the shard
    "corrupt",      # payload bit-flip with prob at inject
    "add_tenant",   # tenant churn: join mid-run with `weight`
    "remove_tenant",  # tenant churn: leave mid-run (backlog shed)
)


@dataclass(frozen=True)
class FaultEvent:
    kind: str
    epoch: int
    shard: int | None = None
    tenant: str | None = None
    nt: str | None = None
    duration: int | None = None   # epochs the fault stays armed (None=forever)
    factor: float = 1.0           # capacity multiplier for `degrade`
    prob: float = 0.0             # per-inject probability for drop/corrupt
    weight: float = 1.0           # tenant weight for `add_tenant`

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.epoch < 0:
            raise ValueError("fault epoch must be >= 0")


@dataclass
class FaultPlan:
    seed: int = 0
    events: list[FaultEvent] = field(default_factory=list)

    # ------------------------------------------------------------ builders --
    def _add(self, **kw) -> "FaultPlan":
        self.events.append(FaultEvent(**kw))
        return self

    def crash(self, shard: int, epoch: int) -> "FaultPlan":
        return self._add(kind="crash", epoch=epoch, shard=shard)

    def hang(self, shard: int, epoch: int,
             duration: int | None = None) -> "FaultPlan":
        return self._add(kind="hang", epoch=epoch, shard=shard,
                         duration=duration)

    def recover(self, shard: int, epoch: int) -> "FaultPlan":
        return self._add(kind="recover", epoch=epoch, shard=shard)

    def degrade(self, shard: int, epoch: int, factor: float,
                duration: int | None = None) -> "FaultPlan":
        if not 0.0 <= factor <= 1.0:
            raise ValueError("degrade factor must be in [0, 1]")
        return self._add(kind="degrade", epoch=epoch, shard=shard,
                         factor=factor, duration=duration)

    def nt_exception(self, shard: int, epoch: int, nt: str,
                     duration: int | None = None) -> "FaultPlan":
        return self._add(kind="nt_exception", epoch=epoch, shard=shard,
                         nt=nt, duration=duration)

    def drop(self, shard: int, epoch: int, prob: float,
             duration: int | None = None) -> "FaultPlan":
        return self._add(kind="drop", epoch=epoch, shard=shard, prob=prob,
                         duration=duration)

    def corrupt(self, shard: int, epoch: int, prob: float,
                duration: int | None = None) -> "FaultPlan":
        return self._add(kind="corrupt", epoch=epoch, shard=shard, prob=prob,
                         duration=duration)

    def add_tenant(self, tenant: str, epoch: int,
                   weight: float = 1.0) -> "FaultPlan":
        return self._add(kind="add_tenant", epoch=epoch, tenant=tenant,
                         weight=weight)

    def remove_tenant(self, tenant: str, epoch: int) -> "FaultPlan":
        return self._add(kind="remove_tenant", epoch=epoch, tenant=tenant)

    # ------------------------------------------------------------- queries --
    def events_at(self, epoch: int) -> list[FaultEvent]:
        return [e for e in self.events if e.epoch == epoch]

    @property
    def max_epoch(self) -> int:
        return max((e.epoch for e in self.events), default=0)

    # ------------------------------------------------------- serialization --
    def to_dict(self) -> dict:
        return {"seed": self.seed, "events": [asdict(e) for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(seed=int(d.get("seed", 0)),
                   events=[FaultEvent(**e) for e in d.get("events", [])])

    def fingerprint(self) -> str:
        """Stable content hash — two plans with the same seed+events share
        it, which is what 'same fault seed reproduces the identical report'
        is asserted against."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]
