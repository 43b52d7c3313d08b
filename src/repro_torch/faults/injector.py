"""FaultInjector: binds a FaultPlan to a live fleet.

The fleet coordinator calls :meth:`advance` once per global epoch,
*before* running the shards, so a fault scheduled for epoch N shapes
epoch N's window.  Timed faults (``duration=k``) are disarmed k epochs
later; tenant-churn events are forwarded to the ``tenancy`` object
(normally the ``ShardedBackend`` itself).
"""
from __future__ import annotations

from typing import Protocol, Sequence

from .plan import FaultEvent, FaultPlan
from .state import FaultState


class _Tenancy(Protocol):
    def add_tenant(self, tenant: str, weight: float) -> None: ...
    def remove_tenant(self, tenant: str) -> None: ...


def faults_of(backend, name: str = "?", seed: int = 0) -> FaultState:
    """Get-or-create the backend's FaultState hook."""
    st = getattr(backend, "faults", None)
    if st is None:
        st = FaultState(name=getattr(backend, "shard_name", name), seed=seed)
        backend.faults = st
    return st


class FaultInjector:
    def __init__(self, plan: FaultPlan, shards: Sequence,
                 names: Sequence[str] | None = None,
                 tenancy: _Tenancy | None = None):
        self.plan = plan
        self.shards = list(shards)
        self.tenancy = tenancy
        self.states: list[FaultState] = []
        for i, sh in enumerate(self.shards):
            nm = names[i] if names else getattr(sh, "name", f"shard{i}")
            self.states.append(
                faults_of(sh, name=nm, seed=plan.seed + 7919 * (i + 1)))
        self.epoch = -1
        self.applied: list[FaultEvent] = []
        self.churn_log: list[tuple[int, str, str]] = []
        # (expiry_epoch, undo) pairs for duration-bounded faults
        self._timers: list[tuple[int, object]] = []

    def attach(self, shard, name: str | None = None) -> FaultState:
        """Arm a late-joining shard (a spare added mid-run) with its own
        seeded FaultState; plan events index shards in attach order."""
        i = len(self.shards)
        self.shards.append(shard)
        nm = name or getattr(shard, "name", f"shard{i}")
        st = faults_of(shard, name=nm, seed=self.plan.seed + 7919 * (i + 1))
        self.states.append(st)
        return st

    # ------------------------------------------------------------ stepping --
    def advance(self, epoch: int) -> list[FaultEvent]:
        """Apply all events due at `epoch`; returns them for logging."""
        self.epoch = epoch
        # expire timed faults first so a re-arm at the same epoch wins
        live, due = [], []
        for exp, undo in self._timers:
            (due if exp <= epoch else live).append((exp, undo))
        self._timers = live
        for _, undo in due:
            undo()
        fired = self.plan.events_at(epoch)
        for ev in fired:
            self._apply(ev)
            self.applied.append(ev)
        return fired

    def _state(self, ev: FaultEvent) -> FaultState:
        if ev.shard is None or not 0 <= ev.shard < len(self.states):
            raise ValueError(f"fault {ev.kind!r} needs a valid shard index, "
                             f"got {ev.shard!r}")
        return self.states[ev.shard]

    def _timed(self, ev: FaultEvent, undo) -> None:
        if ev.duration is not None:
            self._timers.append((ev.epoch + ev.duration, undo))

    def _apply(self, ev: FaultEvent) -> None:
        kind = ev.kind
        if kind == "crash":
            self._state(ev).crashed = True
        elif kind == "hang":
            st = self._state(ev)
            st.hung = True
            self._timed(ev, lambda s=st: setattr(s, "hung", False))
        elif kind == "recover":
            st = self._state(ev)
            st.crashed = st.hung = False
        elif kind == "degrade":
            st = self._state(ev)
            st.degrade = ev.factor
            self._timed(ev, lambda s=st: setattr(s, "degrade", 1.0))
        elif kind == "nt_exception":
            st = self._state(ev)
            st.nt_faults.add(ev.nt)
            self._timed(ev, lambda s=st, n=ev.nt: s.nt_faults.discard(n))
        elif kind == "drop":
            st = self._state(ev)
            st.drop_prob = ev.prob
            self._timed(ev, lambda s=st: setattr(s, "drop_prob", 0.0))
        elif kind == "corrupt":
            st = self._state(ev)
            st.corrupt_prob = ev.prob
            self._timed(ev, lambda s=st: setattr(s, "corrupt_prob", 0.0))
        elif kind in ("add_tenant", "remove_tenant"):
            if self.tenancy is None:
                raise ValueError(
                    f"plan has tenant-churn event {ev.tenant!r} but the "
                    "injector was built without a tenancy object")
            if kind == "add_tenant":
                self.tenancy.add_tenant(ev.tenant, ev.weight)
            else:
                self.tenancy.remove_tenant(ev.tenant)
            self.churn_log.append((ev.epoch, kind, ev.tenant))

    # -------------------------------------------------------------- report --
    def summary(self) -> dict:
        return {
            "plan": self.plan.fingerprint(),
            "applied": len(self.applied),
            "churn": list(self.churn_log),
            "shards": {st.name: st.summary() for st in self.states},
        }
