"""Consolidation-driven placement for a fleet of shard backends (§2, §5).

The paper's economics (Figs 2-3): a pool that provisions the *peak of the
aggregate* load beats per-endpoint peak provisioning exactly when the loads
it packs together do not peak together.  The :class:`Placer` turns that
analysis into runtime decisions:

  - it keeps a per-tenant load history sampled from the per-tenant
    served/deficit monitors every shard's FairScheduler already records
    (the coordinator feeds :meth:`record` one sample per epoch);
  - :meth:`place` scores candidate shards with
    :func:`repro_torch.core.consolidation.analyze` — the chosen shard is
    the one where adding the tenant grows the *fleet's provisioned capacity*
    (sum over shards of each shard's peak-of-aggregate) the least.  Tenants
    whose loads anti-correlate with a shard's residents barely raise its
    peak and get packed together; correlated aggressors raise it by their
    full peak and spread out (ties break toward the emptier shard);
  - :meth:`rebalance` watches each shard's measured peak-of-aggregate
    against its capacity and, on overload, proposes deploy-on-new +
    drain-old moves (the rack migration semantics of the JAX package's
    ``core/distributed.py``, lifted to whole shard backends): evict the
    resident whose departure lowers the shard peak most, to the shard it
    packs best into.

Histories are per *tenant* (the monitors are per tenant); a tenant deployed
on several shards contributes its profile to each, scaled by its share of
deployments there.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.consolidation import analyze


@dataclass
class PlacementDecision:
    """One placement/rebalance decision, for logs and reports."""
    kind: str                         # "place" | "rebalance"
    dag_uid: int
    tenant: str
    shard: int
    reason: str
    scores: dict[int, float] = field(default_factory=dict)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        s = ", ".join(f"s{i}={v:.1f}" for i, v in sorted(self.scores.items()))
        return (f"[{self.kind}] dag {self.dag_uid} ({self.tenant}) -> "
                f"shard {self.shard}  ({self.reason}{'; ' + s if s else ''})")


class Placer:
    """Anti-correlation packing + peak-of-aggregate rebalancing."""

    def __init__(self, capacities: list[float], *, window: int = 256,
                 min_history: int = 4):
        #: per-shard capacity in the same units as recorded load samples
        self.capacities = [float(c) for c in capacities]
        self.window = window
        #: placement falls back to least-loaded until a tenant has this
        #: many samples (cold start: nothing to correlate yet)
        self.min_history = min_history
        self.history: dict[str, deque] = {}
        self.routes: dict[int, int] = {}       # dag_uid -> current shard
        self.owners: dict[int, str] = {}       # dag_uid -> tenant
        self.decisions: list[PlacementDecision] = []
        #: shards excluded from placement/rebalance (failed-over); their
        #: residents can still be counted and moved *off* them
        self.disabled: set[int] = set()

    @property
    def n_shards(self) -> int:
        return len(self.capacities)

    # ----------------------------------------------------------- liveness --
    def candidates(self) -> list[int]:
        return [s for s in range(self.n_shards) if s not in self.disabled]

    def disable(self, shard: int) -> None:
        self.disabled.add(shard)

    def enable(self, shard: int) -> None:
        self.disabled.discard(shard)

    def set_capacity(self, shard: int, capacity: float) -> None:
        """Live capacity refresh (degradation feeds the placer too)."""
        self.capacities[shard] = float(capacity)

    def add_shard(self, capacity: float) -> int:
        """Grow the fleet by one (spare) shard; returns its index."""
        self.capacities.append(float(capacity))
        return self.n_shards - 1

    # ---------------------------------------------------------- monitors --
    def record(self, tenant: str, load: float) -> None:
        """One load sample (e.g. Gbps served+backlogged this epoch) from the
        scheduler monitors; the history ring is the tenant's load profile."""
        h = self.history.get(tenant)
        if h is None:
            h = self.history[tenant] = deque(maxlen=self.window)
        h.append(float(load))

    def profile(self, tenant: str) -> np.ndarray | None:
        h = self.history.get(tenant)
        if not h:
            return None
        return np.asarray(h, dtype=np.float64)

    def deployments_of(self, tenant: str,
                       shard: int | None = None) -> list[int]:
        """The tenant's dag uids (on one shard, or fleet-wide), sorted."""
        return sorted(u for u, t in self.owners.items()
                      if t == tenant and
                      (shard is None or self.routes[u] == shard))

    def _fractions(self, shard: int) -> dict[str, float]:
        """tenant -> fraction of its profile attributed to ``shard`` (its
        deployments there over its deployments everywhere)."""
        out: dict[str, float] = {}
        for t in {self.owners[u] for u in self.routes}:
            total = len(self.deployments_of(t))
            here = len(self.deployments_of(t, shard))
            if total:
                out[t] = here / total
        return out

    def _resident_rows(self, shard: int, *,
                       scale: dict[str, float] | None = None,
                       extra: np.ndarray | None = None) -> list[np.ndarray]:
        """Resident tenants' profiles on ``shard``, each scaled by the
        fraction of the tenant's deployments living there.  ``scale``
        overrides a tenant's fraction (projection: what if one of its
        deployments moved here / away); ``extra`` appends a raw profile."""
        rows = []
        seen: set[str] = set()
        for t, frac in self._fractions(shard).items():
            seen.add(t)
            if scale is not None and t in scale:
                frac = scale[t]
            if frac <= 0:
                continue
            p = self.profile(t)
            if p is not None:
                rows.append(p * frac)
        # a tenant with no deployments anywhere is absent from _fractions;
        # its scale override IS its projected row
        for t, frac in (scale or {}).items():
            if t in seen or frac <= 0:
                continue
            p = self.profile(t)
            if p is not None:
                rows.append(p * frac)
        if extra is not None:
            rows.append(extra)
        return rows

    def shard_peak(self, shard: int, *,
                   scale: dict[str, float] | None = None,
                   extra: np.ndarray | None = None) -> float:
        """Measured (or projected, via ``scale``/``extra``) peak of the
        shard's aggregate load — what the shard must provision."""
        rows = self._resident_rows(shard, scale=scale, extra=extra)
        if not rows:
            return 0.0
        n = max(len(r) for r in rows)
        mat = np.zeros((len(rows), n))
        for i, r in enumerate(rows):
            mat[i, n - len(r):] = r       # align on the most recent sample
        return analyze(mat).peak_of_aggregate

    def shard_load(self, shard: int) -> int:
        return sum(1 for s in self.routes.values() if s == shard)

    # --------------------------------------------------------- placement --
    def place(self, tenant: str, dag_uid: int) -> PlacementDecision:
        """Pick a shard for a new deployment and record the assignment.

        Disabled (failed-over) shards are never candidates; with every
        shard disabled there is nowhere to place, which the caller counts
        as a lost deployment."""
        cands = self.candidates()
        if not cands:
            raise ValueError("no enabled shard to place on")
        prof = self.profile(tenant)
        if prof is None or len(prof) < self.min_history:
            shard = min(cands, key=lambda s: (self.shard_load(s), s))
            dec = PlacementDecision("place", dag_uid, tenant, shard,
                                    "cold start: least-loaded shard")
        else:
            # projection: after the deploy the tenant owns total+1 dags, of
            # which here+1 sit on the candidate — so the candidate carries
            # (here+1)/(total+1) of its profile.  A tenant adding a second
            # DAG beside its first is free here, not double-counted.
            total = len(self.deployments_of(tenant))
            scores: dict[int, float] = {}
            feas: dict[int, bool] = {}
            for s in cands:
                here = len(self.deployments_of(tenant, s))
                frac = (here + 1) / (total + 1)
                projected = self.shard_peak(s, scale={tenant: frac})
                scores[s] = projected - self.shard_peak(s)
                feas[s] = projected <= self.capacities[s]
            shard = min(cands,
                        key=lambda s: (not feas[s], scores[s],
                                       self.shard_load(s), s))
            dec = PlacementDecision(
                "place", dag_uid, tenant, shard,
                "min fleet-peak increase (anti-correlation packing)"
                if feas[shard] else "least overload (no feasible shard)",
                scores)
        self.assign(dag_uid, tenant, shard)
        self.decisions.append(dec)
        return dec

    def assign(self, dag_uid: int, tenant: str, shard: int) -> None:
        self.routes[dag_uid] = shard
        self.owners[dag_uid] = tenant

    # -------------------------------------------------------- rebalancing --
    def overloaded(self) -> list[int]:
        """Shards whose measured peak-of-aggregate exceeds capacity."""
        return [s for s in self.candidates()
                if self.shard_peak(s) > self.capacities[s]]

    def propose_moves(self) -> list[tuple[int, int, int]]:
        """Propose ``(dag_uid, src, dst)`` moves for overloaded shards
        WITHOUT applying them — the caller performs the deploy-on-new +
        drain-old and records each accepted move via :meth:`assign`.

        Projections are per-deployment: moving one of a tenant's ``k``
        deployments shifts ``1/k`` of its profile, so a feasible partial
        move is not refused just because the tenant's whole load would not
        fit at the destination."""
        moves: list[tuple[int, int, int]] = []
        if len(self.candidates()) < 2:
            return moves                      # nowhere to move anything
        for s in self.overloaded():
            fracs = self._fractions(s)
            residents = sorted(t for t, f in fracs.items() if f > 0)
            if len(residents) < 2:
                continue                      # a lone tenant can't unpack
            base = self.shard_peak(s)         # loop-invariant
            cands = []
            for t in residents:
                if self.profile(t) is None:
                    continue
                total = len(self.deployments_of(t))
                src_after = fracs[t] - 1.0 / total
                red = base - self.shard_peak(s, scale={t: src_after})
                if red > 0:
                    cands.append((t, red, 1.0 / total))
            if not cands:
                continue                      # nothing movable would help
            tenant, _red, step = max(cands, key=lambda x: x[1])
            total = len(self.deployments_of(tenant))
            others = [d for d in self.candidates() if d != s]
            if not others:
                continue
            projected = {
                d: self.shard_peak(d, scale={
                    tenant: len(self.deployments_of(tenant, d)) / total
                    + step})
                for d in others}
            dst = min(others, key=lambda d: (
                projected[d] > self.capacities[d],
                projected[d] - self.shard_peak(d),
                self.shard_load(d), d))
            if projected[dst] > self.capacities[dst]:
                continue                      # would just move the overload
            uid = self.deployments_of(tenant, s)[0]
            moves.append((uid, s, dst))
        return moves

    def rebalance(self) -> list[tuple[int, int, int]]:
        """Propose and APPLY moves (standalone use; a coordinating backend
        calls :meth:`propose_moves` and applies through its own migrate)."""
        moves = self.propose_moves()
        for uid, s, dst in moves:
            self.record_move(uid, s, dst)
        return moves

    def record_move(self, uid: int, src: int, dst: int) -> None:
        """Reassign one deployment and log the rebalance decision."""
        tenant = self.owners[uid]
        self.assign(uid, tenant, dst)
        self.decisions.append(PlacementDecision(
            "rebalance", uid, tenant, dst,
            f"shard {src} peak over capacity; best anti-correlated fit"))

    # ------------------------------------------------------------ economics --
    def savings(self) -> dict:
        """Consolidation economics actually achieved by the current
        placement: per-tenant peak provisioning vs what the fleet's shards
        must provision (sum of per-shard peak-of-aggregate), plus the ideal
        single-pool bound."""
        peaks = {t: float(np.max(p)) for t, p in
                 ((t, self.profile(t)) for t in self.history)
                 if p is not None and len(p)}
        sum_of_peaks = sum(peaks.values())
        shard_peaks = [self.shard_peak(s) for s in range(self.n_shards)]
        rows = [self.profile(t) for t in self.history]
        rows = [r for r in rows if r is not None and len(r)]
        ideal = 0.0
        if rows:
            n = max(len(r) for r in rows)
            mat = np.zeros((len(rows), n))
            for i, r in enumerate(rows):
                mat[i, n - len(r):] = r
            ideal = analyze(mat).peak_of_aggregate
        provisioned = sum(shard_peaks)
        return {
            "sum_of_peaks": sum_of_peaks,
            "per_shard_peaks": shard_peaks,
            "sum_of_shard_peaks": provisioned,
            "peak_of_aggregate": ideal,
            "savings": sum_of_peaks / max(provisioned, 1e-12),
            "ideal_savings": sum_of_peaks / max(ideal, 1e-12),
        }


__all__ = ["Placer", "PlacementDecision"]
