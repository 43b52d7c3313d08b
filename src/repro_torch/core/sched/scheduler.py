"""The FairScheduler facade: one object per substrate, three shared loops.

A substrate wires in three pluggable hooks and keeps only its mechanism
(event wheels, kernel dispatch, model steps):

  - ``Clock``    — ``() -> now`` in whatever time unit the substrate lives
    in (simulated ns, host seconds).  Every credit refill, monitor window
    and latency stamp uses it, so the same scheduler is exact under a
    discrete-event clock and a wall clock.
  - ``Capacity`` — ``() -> {resource: capacity per epoch}``; consulted when
    :meth:`FairScheduler.epoch` is called without an explicit vector (the
    sNIC derives NT capacities from live regions, the engine from its
    config).
  - ``Scale``    — anything with ``decide(name, served, capacity, now,
    n_instances) -> ScaleDecision`` (e.g.
    :class:`repro_torch.core.policy.UtilizationScaler`); the substrate applies
    the mechanism (region PR, batch-shape recompile) for the returned
    direction.

Two service disciplines cover the three substrates:

  - **paced** (:meth:`poll`): departures gated by per-tenant token buckets
    whose rates come from epoch DRF grants — the sNIC's ingress throttles;
  - **batched** (:meth:`drain` / :meth:`admit`): WDRR order over the queued
    work, optionally gated by per-tenant epoch budgets — ComputeBackend's
    dispatch composition and the engine's admission.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator, Protocol

from ..drf import DRFResult
from .queues import COST_EPS, QueueItem, TenantQueue
from .spaceshare import SpaceShare
from .timeshare import DeficitRoundRobin


class Clock(Protocol):
    def __call__(self) -> float: ...


class Scale(Protocol):
    def decide(self, name: str, served: float, capacity: float,
               now: float, n_instances: int): ...


@dataclass
class SchedConfig:
    """Knobs shared by every TenantQueue the scheduler creates."""
    quantum: float = 1500.0              # WDRR deficit per round per weight
    max_backlog: float | None = None     # per-tenant queued-cost cap
    bucket_window: float = 0.0           # token-bucket depth (time units)
    min_retry: float = 0.0               # pacing retry clamp
    max_retry: float = math.inf
    #: strict tenancy: submit() for an unregistered tenant raises KeyError
    #: instead of silently auto-registering at weight 1.0 (the compute
    #: substrate wants the error; the sim's open traffic sources want the
    #: auto-registration the sNIC always had)
    strict: bool = True


class FairScheduler:
    """Fair space sharing + fair time sharing over per-tenant queues."""

    def __init__(self, weights: dict[str, float] | None = None,
                 config: SchedConfig | None = None, *,
                 clock: Clock | None = None,
                 capacity: Callable[[], dict[str, float]] | None = None,
                 scale: Scale | None = None):
        self.cfg = config or SchedConfig()
        self.clock: Clock = clock or (lambda: 0.0)
        self.capacity = capacity
        self.scale = scale
        #: registration order == WDRR ring order (never name-sorted)
        self.queues: dict[str, TenantQueue] = {}
        self.space = SpaceShare({})
        self.wdrr = DeficitRoundRobin(self.cfg.quantum)
        for t, w in (weights or {}).items():
            self.add_tenant(t, w)

    # ============================================================ tenancy ==
    def add_tenant(self, name: str, weight: float = 1.0) -> TenantQueue:
        q = self.queues.get(name)
        if q is None:
            q = TenantQueue(name, weight,
                            max_backlog=self.cfg.max_backlog,
                            bucket_window=self.cfg.bucket_window,
                            min_retry=self.cfg.min_retry,
                            max_retry=self.cfg.max_retry)
            self.queues[name] = q
        else:
            q.weight = weight
        self.space.weights[name] = weight
        return q

    def remove_tenant(self, name: str) -> tuple[int, float]:
        """Tenant churn: drop the tenant's queue (its backlog is shed and
        counted) and forget its weight.  Safe mid-run — the WDRR ring is
        the queues dict itself and deficit state lives on the queue, so
        nothing else references the departed tenant.  Returns the
        ``(items, cost)`` shed with the queue."""
        q = self.queues.pop(name, None)
        self.space.weights.pop(name, None)
        self.space.admission.demand.pop(name, None)
        if q is None:
            return (0, 0.0)
        return q.shed(0.0)

    def shed_backlog(self, tenant: str, cost_limit: float) -> tuple[int, float]:
        """Cap one tenant's standing backlog (graceful degradation when
        fleet capacity < demand); see :meth:`TenantQueue.shed`."""
        q = self.queues.get(tenant)
        if q is None:
            return (0, 0.0)
        return q.shed(cost_limit)

    @property
    def weights(self) -> dict[str, float]:
        return {n: q.weight for n, q in self.queues.items()}

    def queue(self, tenant: str) -> TenantQueue:
        q = self.queues.get(tenant)
        if q is None:
            if self.cfg.strict:
                raise KeyError(
                    f"tenant {tenant!r} is not registered with the "
                    f"scheduler (known: {sorted(self.queues)}); register "
                    "it (with its weight) before injecting")
            q = self.add_tenant(tenant)
        return q

    # ============================================================ ingress ==
    def submit(self, tenant: str, payload, cost: float,
               costs: dict[str, float] | None = None) -> bool:
        """Enqueue one work item; False = dropped on the backlog cap."""
        return self.queue(tenant).push(payload, cost, costs,
                                       now=self.clock())

    def requeue(self, tenant: str, payload, cost: float,
                costs: dict[str, float] | None = None) -> None:
        """Head-of-line return of an admitted-but-unrunnable item (e.g. no
        memory right now); keeps its place, never dropped.  The admission
        charged WDRR deficit and the served monitors when it popped the
        item — the item was NOT actually served, so both are reversed here
        (otherwise every retry would double-charge the tenant's time share
        and inflate its served accounting)."""
        q = self.queue(tenant)
        q.push_front(payload, cost, costs, now=self.clock())
        q.deficit += cost
        q.served_cost -= cost
        q.served_items -= 1

    def queued(self, tenant: str) -> int:
        q = self.queues.get(tenant)
        return len(q) if q is not None else 0

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # ================================================= time sharing: paced ==
    def poll(self, tenant: str) -> tuple[object | None, float | None]:
        """Pop the tenant's head item if its token credits cover the cost.

        Returns ``(payload, 0.0)`` on service, ``(None, retry_delay)`` when
        the head must wait for credits, ``(None, None)`` when the queue is
        empty — the delay is pre-clamped so an event-driven caller can
        schedule the retry directly.
        """
        q = self.queues.get(tenant)
        if q is None or not len(q):
            return None, None
        now = self.clock()
        if q.ready(now):
            item = q.pop()
            q.spend(item.cost)
            return item.payload, 0.0
        return None, q.retry_delay(now)

    def set_rate(self, tenant: str, rate: float) -> None:
        self.queue(tenant).set_rate(rate, self.clock())

    # =============================================== time sharing: batched ==
    def drain(self, *, gate=None, stop=None,
              ) -> Iterator[tuple[str, QueueItem]]:
        """Serve queued items in WDRR order (see
        :meth:`DeficitRoundRobin.drain` for the gate/stop hooks)."""
        return self.wdrr.drain(self.queues, gate=gate, stop=stop)

    def admit(self, budgets: dict[str, float] | None = None, *,
              limit: int | None = None, work_conserving: bool = True,
              ) -> list[tuple[str, QueueItem]]:
        """Admission pass: WDRR order, each tenant gated by its scalar
        budget (same units as item cost), at most ``limit`` items.

        Work-conserving fallback: if the budgets admit nothing while work
        is queued (one item alone can exceed a fair share), admit the head
        item of the first tenant in WDRR order — deterministic and
        weight/deficit-based, never name-based — so the system always makes
        progress.
        """
        out: list[tuple[str, QueueItem]] = []
        remaining = dict(budgets or {})

        def gate(q: TenantQueue, item: QueueItem) -> bool:
            return remaining.get(q.name, 0.0) >= item.cost - COST_EPS

        def stop() -> bool:
            return limit is not None and len(out) >= limit

        for tenant, item in self.drain(gate=gate, stop=stop):
            remaining[tenant] = remaining.get(tenant, 0.0) - item.cost
            out.append((tenant, item))
        if not out and work_conserving and self.pending():
            for tenant, item in self.drain(stop=lambda: bool(out)):
                out.append((tenant, item))
                break
        return out

    def stream_window(self, epoch_cost: float | None = None, *,
                      limit: int | None = None,
                      ) -> list[tuple[str, QueueItem]]:
        """One streaming-epoch service window: pop queued items in WDRR
        order until ``epoch_cost`` total cost (or ``limit`` items) has been
        granted, leaving the remainder queued for the next epoch.

        This is the stream-credit hook a pipelined datapath services
        epoch-by-epoch instead of draining its whole backlog — the
        scheduler's grants shape what enters the stream's in-flight window
        (resource decisions pushed down into the datapath layer, not bounced
        through a host control loop).  ``None`` = no cost cap (a full fair
        drain).  Always admits at least one item when work is queued, so a
        single over-budget batch cannot stall the stream."""
        out: list[tuple[str, QueueItem]] = []
        granted = 0.0

        def stop() -> bool:
            if limit is not None and len(out) >= limit:
                return True
            return (epoch_cost is not None and bool(out)
                    and granted >= epoch_cost - COST_EPS)

        for tenant, item in self.drain(stop=stop):
            out.append((tenant, item))
            granted += item.cost
        return out

    # ====================================================== space sharing ==
    def observe(self, tenant: str, resource: str, amount: float) -> None:
        self.space.observe(tenant, resource, amount)

    def backlog_demand(self, resource: str | None = None,
                       ) -> dict[str, dict[str, float]]:
        """Standing backlog as extra DRF demand.  With ``resource``, the
        scalar queued cost is reported under that one name (the sNIC counts
        backlog bytes as ingress demand); otherwise each item's full cost
        vector is summed."""
        out: dict[str, dict[str, float]] = {}
        for t, q in self.queues.items():
            if not len(q):
                continue
            out[t] = ({resource: q.backlog_cost} if resource is not None
                      else q.backlog_costs())
        return out

    def epoch(self, capacities: dict[str, float] | None = None,
              extra: dict[str, dict[str, float]] | None = None,
              ) -> DRFResult | None:
        """One space-sharing epoch: solve weighted DRF over the measured
        demand window (plus ``extra``) against ``capacities`` (defaults to
        the Capacity hook).  The caller turns the result into rates or
        budgets via :class:`SpaceShare`."""
        if capacities is None:
            if self.capacity is None:
                raise ValueError("epoch() needs capacities or a Capacity "
                                 "hook")
            capacities = self.capacity()
        return self.space.epoch(capacities, extra=extra)

    # ======================================================== cross-shard ==
    def demand(self, resource: str = "ingress",
               include_backlog: bool = True) -> dict[str, float]:
        """Peek this scheduler's per-tenant scalar demand for ``resource``
        over the current space-share window (measured offered load plus,
        optionally, standing backlog) WITHOUT solving or ending the window.

        This is the per-shard vector a cross-shard coordinator aggregates:
        each shard keeps one FairScheduler, a global epoch sums these
        vectors, solves fleet-wide weighted fairness
        (:func:`cross_shard_epoch`) and hands every shard its grants; the
        coordinator then calls :meth:`end_window` so the next epoch measures
        fresh.
        """
        out: dict[str, float] = {}
        for t, d in self.space.admission.demands().items():
            v = d.get(resource, 0.0)
            if v > 0.0:
                out[t] = v
        if include_backlog:
            for t, d in self.backlog_demand(resource).items():
                out[t] = out.get(t, 0.0) + d[resource]
        return out

    def end_window(self) -> None:
        """Start a fresh space-share measurement window (a cross-shard
        epoch consumed this one instead of the local :meth:`epoch`)."""
        self.space.admission.demand = {}

    # ============================================================ scaling ==
    def autoscale(self, name: str, served: float, capacity: float,
                  n_instances: int) -> int:
        """Scale direction (+1/0/-1) for one scaled entity, via the Scale
        hook (0 when no hook is configured)."""
        if self.scale is None:
            return 0
        return self.scale.decide(name, served, capacity, self.clock(),
                                 n_instances).direction

    # ========================================================== reporting ==
    def snapshot(self) -> dict[str, dict[str, float]]:
        """Per-tenant monitor readout for reports/benchmarks."""
        return {n: {"weight": q.weight, "queued": float(len(q)),
                    "backlog_cost": q.backlog_cost,
                    "served_cost": q.served_cost,
                    "served_items": float(q.served_items),
                    "drops": float(q.drops), "deficit": q.deficit}
                for n, q in self.queues.items()}


# ================================================== cross-shard space share ==
def _waterfill(demand: dict[str, float], cap: float,
               weights: dict[str, float],
               base: dict[str, float]) -> dict[str, float]:
    """One shard's capacity split so every tenant's *global* weighted share
    ``(base_t + grant_t) / w_t`` is equalized, subject to
    ``0 <= grant_t <= demand_t`` and ``sum(grant) = min(cap, sum(demand))``.

    ``base_t`` is what the tenant already holds on other shards — a tenant
    drawing heavily elsewhere starts deeper in the water column and yields
    local capacity to tenants whose only outlet is this shard.  Solved by
    bisection on the water level (find level L with
    ``sum(clip(L * w_t - base_t, 0, demand_t)) = total``).
    """
    tenants = [t for t, d in demand.items() if d > 0.0]
    if not tenants or cap <= 0.0:
        return {t: 0.0 for t in demand}
    total = min(cap, sum(demand[t] for t in tenants))

    def grants(level: float) -> dict[str, float]:
        return {t: min(max(level * max(weights.get(t, 1.0), 1e-12)
                           - base.get(t, 0.0), 0.0), demand[t])
                for t in tenants}

    hi = max((demand[t] + base.get(t, 0.0))
             / max(weights.get(t, 1.0), 1e-12) for t in tenants) + 1.0
    lo = 0.0
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if sum(grants(mid).values()) < total:
            lo = mid
        else:
            hi = mid
    out = grants(hi)
    for t in demand:
        out.setdefault(t, 0.0)
    return out


def cross_shard_epoch(demands: dict, capacities: dict,
                      weights: dict[str, float], *,
                      rounds: int = 4) -> dict:
    """One *global* space-share epoch over a fleet of shard schedulers.

    ``demands[shard][tenant]`` is each shard scheduler's
    :meth:`FairScheduler.demand` vector for the window,
    ``capacities[shard]`` the shard's capacity in the same cost units, and
    ``weights`` the fleet-wide tenant weights.  Returns
    ``grants[shard][tenant]`` such that fleet-wide *weighted* shares are
    max-min fair across shards while every shard stays feasible and no
    capacity a demanding tenant could use is left idle (work conserving).

    A tenant's demand is pinned to the shards its deployments live on (load
    cannot be rerouted by the solver — that is the placer's job), so this is
    weighted max-min with per-shard capacity constraints.  Solved by
    Gauss-Seidel sweeps of per-shard water-filling where a tenant's grants
    on *other* shards count as a head start against it; a few rounds
    converge because each sweep only moves grants toward the fixed point.
    """
    shards = list(demands)
    grants: dict = {s: {t: 0.0 for t in demands[s]} for s in shards}
    for _ in range(max(rounds, 1)):
        for s in shards:
            if not demands[s]:
                continue
            base = {t: sum(grants[o].get(t, 0.0)
                           for o in shards if o != s)
                    for t in demands[s]}
            grants[s] = _waterfill(demands[s], capacities.get(s, 0.0),
                                   weights, base)
    return grants
