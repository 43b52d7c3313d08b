"""Reusable resource-policy components (paper §4.4, C5).

Both substrates that schedule real work — the event-driven sNIC device model
(:mod:`repro_torch.core.snic`) and the ML serving engine
(:mod:`repro_torch.serving.engine`) — run the same two control loops:

  - **run-time-monitored DRF admission**: accumulate *measured* per-tenant
    demand vectors over an epoch (offered load, captured before any credit or
    budget gating), solve weighted DRF against the capacity vector, and turn
    the grants into ingress throttles / admission budgets;
  - **instance autoscaling**: watch a utilization (or backlog) signal and
    scale an NT's instance count (or the decode batch shape) out/in, with
    hysteresis so transient spikes don't thrash slow reconfiguration.

These classes hold the policy state machines; the substrates keep only the
mechanism (token buckets, region launches, kernel builds).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .drf import DRFResult, drf_allocate


class DRFAdmission:
    """Epoch-scoped measured-demand accumulator + weighted-DRF solver.

    Usage per epoch::

        adm.observe(tenant, "ingress", nbytes)   # on every arrival
        ...
        res = adm.allocate(caps)                 # solve + reset the window
        grant = res.alloc[tenant]["ingress"]
    """

    def __init__(self, weights: dict[str, float] | None = None):
        self.weights = dict(weights or {})
        self.demand: dict[str, dict[str, float]] = {}
        self.last_result: DRFResult | None = None

    def observe(self, tenant: str, resource: str, amount: float) -> None:
        d = self.demand.setdefault(tenant, {})
        d[resource] = d.get(resource, 0.0) + amount

    def observed(self, tenant: str) -> dict[str, float]:
        return dict(self.demand.get(tenant, {}))

    def demands(self) -> dict[str, dict[str, float]]:
        """Non-empty measured demand vectors for the current epoch."""
        return {t: dict(d) for t, d in self.demand.items() if d}

    def allocate(self, capacities: dict[str, float],
                 extra: dict[str, dict[str, float]] | None = None,
                 reset: bool = True) -> DRFResult | None:
        """Solve weighted DRF over the epoch's measured demands.

        ``extra`` merges additional demand (e.g. standing backlog) into the
        measured vectors without polluting the monitor itself.  Returns None
        when nothing was observed.  ``reset`` starts the next epoch window.
        """
        demands = self.demands()
        for t, d in (extra or {}).items():
            dst = demands.setdefault(t, {})
            for r, v in d.items():
                dst[r] = dst.get(r, 0.0) + v
        if reset:
            self.demand = {}
        if not demands:
            return None
        self.last_result = drf_allocate(demands, capacities, self.weights)
        return self.last_result


@dataclass
class ScaleDecision:
    direction: int          # +1 scale out, -1 scale in, 0 hold
    utilization: float = 0.0


class UtilizationScaler:
    """Watermark autoscaler with dwell-time hysteresis (paper §4.4).

    A scale-out fires only after utilization has stayed at/above ``hi`` for
    ``dwell_ns``; scale-in after staying at/below ``lo`` for ``dwell_ns``
    (and only while more than one instance is live).  One instance of this
    class tracks every scaled entity by name.
    """

    def __init__(self, hi: float, lo: float, dwell_ns: float):
        self.hi = hi
        self.lo = lo
        self.dwell_ns = dwell_ns
        self.overload_since: dict[str, float | None] = {}
        self.underload_since: dict[str, float | None] = {}

    def decide(self, name: str, served: float, capacity: float,
               now_ns: float, n_instances: int) -> ScaleDecision:
        util = served / max(capacity, 1e-9)
        direction = 0
        if util >= self.hi:
            if self.overload_since.get(name) is None:
                self.overload_since[name] = now_ns
            elif now_ns - self.overload_since[name] >= self.dwell_ns:
                direction = 1
                self.overload_since[name] = None
        else:
            self.overload_since[name] = None
        if util <= self.lo and n_instances > 1:
            if self.underload_since.get(name) is None:
                self.underload_since[name] = now_ns
            elif now_ns - self.underload_since[name] >= self.dwell_ns:
                direction = -1
                self.underload_since[name] = None
        else:
            self.underload_since[name] = None
        return ScaleDecision(direction, util)


@dataclass
class StepScaler:
    """Discrete-ladder autoscaler: pick the next size up/down a sorted ladder
    of deployable shapes from a backlog-vs-capacity signal (the serving
    engine's decode-batch analogue of instance autoscaling)."""

    sizes: tuple
    scale_up_ratio: float = 2.0
    scale_down_ratio: float = 0.25

    def __post_init__(self):
        self.sizes = tuple(sorted(self.sizes))

    def decide(self, current: int, backlog: float) -> int:
        sizes = self.sizes
        idx = sizes.index(current)
        if backlog > current * self.scale_up_ratio and idx < len(sizes) - 1:
            return sizes[idx + 1]
        if backlog < current * self.scale_down_ratio and idx > 0:
            return sizes[idx - 1]
        return current
