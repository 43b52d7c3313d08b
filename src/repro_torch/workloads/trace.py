"""Trace: a fully-materialized, replayable datacenter scenario.

A trace is *data*, not code: the tenant census (name, weight, chain,
packet size, join/leave epochs) plus the integer arrival schedule
(epoch, tenant, pkts).  Everything stochastic happened at generation
time with seeded RNG, so a trace round-trips through ``to_dict`` /
``from_dict`` losslessly, carries a sha256 ``fingerprint()`` over its
canonical JSON, and replays bit-identically on any substrate — the
scenario bench asserts all three.

Lifecycle churn compiles to the existing fault plane:
:meth:`Trace.fault_plan` emits the ``add_tenant`` / ``remove_tenant``
:class:`~repro_torch.faults.FaultPlan` events for every tenant whose join
or leave falls inside the horizon, optionally merged over a base plan
(e.g. a shard crash) so one plan drives churn and failure together.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class TraceTenant:
    """One tenant's static description inside a trace."""
    name: str
    weight: float = 1.0
    chain: tuple[str, ...] = ("firewall", "nat")
    pkt_bytes: int = 1000
    join_epoch: int = 0
    leave_epoch: int | None = None      # None = stays to the horizon

    def __post_init__(self):
        if self.join_epoch < 0:
            raise ValueError("join_epoch must be >= 0")
        if self.leave_epoch is not None \
                and self.leave_epoch <= self.join_epoch:
            raise ValueError("leave_epoch must be > join_epoch")
        if not self.chain:
            raise ValueError("tenant chain must name >= 1 NT")
        if self.pkt_bytes < 1:
            raise ValueError("pkt_bytes must be >= 1")

    def live_at(self, epoch: int) -> bool:
        return self.join_epoch <= epoch and (
            self.leave_epoch is None or epoch < self.leave_epoch)


@dataclass
class Trace:
    """A named, seeded scenario: tenants + integer arrival schedule."""
    name: str
    seed: int
    epochs: int
    tenants: list[TraceTenant] = field(default_factory=list)
    #: arrival schedule: (epoch, tenant_name, pkts), sorted by
    #: (epoch, tenant) — the canonical replay order on every substrate
    events: list[tuple[int, str, int]] = field(default_factory=list)
    #: optional epoch window hint in ns (None = the backend's own epoch)
    epoch_ns: float | None = None

    def __post_init__(self):
        self.events = sorted(
            (int(e), str(t), int(n)) for e, t, n in self.events)

    # ------------------------------------------------------------ queries --
    def tenant(self, name: str) -> TraceTenant:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(f"trace has no tenant {name!r}")

    def census(self, epoch: int) -> list[str]:
        """Sorted names of the tenants live at ``epoch``."""
        return sorted(t.name for t in self.tenants if t.live_at(epoch))

    def arrivals(self, epoch: int) -> list[tuple[str, int]]:
        """(tenant, pkts) pairs due at ``epoch``, in canonical order."""
        return [(t, n) for e, t, n in self.events if e == epoch and n > 0]

    @property
    def total_pkts(self) -> int:
        return sum(n for _, _, n in self.events)

    def offered_pkts(self) -> dict[str, int]:
        """Per-tenant total arrivals over the horizon."""
        out: dict[str, int] = {}
        for _, t, n in self.events:
            out[t] = out.get(t, 0) + n
        return out

    # ------------------------------------------------------------- faults --
    def fault_plan(self, base=None):
        """Compile the lifecycle churn into
        :class:`~repro_torch.faults.FaultPlan` ``add_tenant`` /
        ``remove_tenant`` events (epoch-keyed, exactly the fleet
        coordinator's churn hooks).  ``base`` merges the events into
        an existing plan (e.g. one carrying a shard crash) — the combined
        plan keeps ``base``'s seed so the scenario stays one-seed
        reproducible."""
        from repro_torch.faults import FaultPlan
        plan = base if base is not None else FaultPlan(seed=self.seed)
        for t in self.tenants:
            if t.join_epoch > 0:
                plan.add_tenant(t.name, epoch=t.join_epoch, weight=t.weight)
            if t.leave_epoch is not None and t.leave_epoch <= self.epochs:
                plan.remove_tenant(t.name, epoch=t.leave_epoch)
        return plan

    # ------------------------------------------------- serialization ------
    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": self.seed, "epochs": self.epochs,
            "epoch_ns": self.epoch_ns,
            "tenants": [asdict(t) for t in self.tenants],
            "events": [list(e) for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        tenants = []
        for t in d.get("tenants", []):
            t = dict(t)
            t["chain"] = tuple(t.get("chain", ()))
            tenants.append(TraceTenant(**t))
        return cls(name=str(d["name"]), seed=int(d["seed"]),
                   epochs=int(d["epochs"]),
                   tenants=tenants,
                   events=[tuple(e) for e in d.get("events", [])],
                   epoch_ns=d.get("epoch_ns"))

    def fingerprint(self) -> str:
        """Stable content hash over the canonical JSON — the identity the
        perf trajectory and the replay invariants key on."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


__all__ = ["Trace", "TraceTenant"]
