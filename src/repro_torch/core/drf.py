"""Run-time-monitored (weighted) Dominant Resource Fairness (paper §4.4, C5).

Differences from classic DRF [Ghodsi et al., NSDI'11] that the paper
introduces and we reproduce:
  1. every internal resource is a dimension: ingress/egress bandwidth, packet
     store, on-board memory, and *each NT's* service bandwidth;
  2. the demand vector is **measured** each epoch (offered load captured
     before credit assignment), not user-supplied;
  3. the computed allocation is enforced only via *ingress throttling*
     (all other resource usages are proportional to ingress bandwidth),
     except on-board memory which the vmem system enforces directly.

``drf_allocate`` is the fluid-limit progressive-filling solver: grow every
unsatisfied tenant's dominant share at a rate proportional to its weight
until a resource saturates or the tenant's demand is met.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DRFResult:
    # tenant -> resource -> allocated amount (same units as demand/capacity)
    alloc: dict[str, dict[str, float]]
    # tenant -> dominant resource name
    dominant: dict[str, str]
    # tenant -> dominant share in [0, 1]
    dominant_share: dict[str, float]

    def scale(self, tenant: str) -> float:
        """Fraction of the tenant's demand that was granted (<= 1)."""
        return self.alloc[tenant].get("__scale__", 1.0)


def drf_allocate(demands: dict[str, dict[str, float]],
                 capacities: dict[str, float],
                 weights: dict[str, float] | None = None,
                 eps: float = 1e-9) -> DRFResult:
    """demands[tenant][resource] = measured offered load this epoch.

    Returns per-tenant grants; a tenant's grant is ``scale * demand`` with a
    single scalar per tenant (allocations stay proportional to the measured
    vector — the paper enforces them through one ingress rate anyway).
    """
    tenants = [t for t, d in demands.items()
               if any(v > eps for v in d.values())]
    weights = weights or {}
    w = {t: float(weights.get(t, 1.0)) for t in tenants}

    # dominant share per unit of scale: max_r demand_r / capacity_r
    dom_res: dict[str, str] = {}
    dom_per_scale: dict[str, float] = {}
    for t in tenants:
        best, best_r = 0.0, ""
        for r, v in demands[t].items():
            cap = capacities.get(r, 0.0)
            if cap <= eps:
                continue
            s = v / cap
            if s > best:
                best, best_r = s, r
        dom_res[t] = best_r
        dom_per_scale[t] = best
    # tenants with no capacity-limited demand get everything they asked
    scale = {t: (1.0 if dom_per_scale[t] <= eps else 0.0) for t in tenants}
    active = {t for t in tenants if dom_per_scale[t] > eps}

    # remaining capacity after zero-demand grants
    used = {r: 0.0 for r in capacities}
    for _ in range(len(tenants) * max(len(capacities), 1) + 8):
        if not active:
            break
        # rate of resource consumption if each active tenant's scale grows
        # at d(scale)/dt = w_t / dom_per_scale_t  (equal weighted dominant-
        # share growth)
        rate = {t: w[t] / dom_per_scale[t] for t in active}
        # time until a resource saturates
        t_res, lim_r = float("inf"), None
        for r, cap in capacities.items():
            cons = sum(rate[t] * demands[t].get(r, 0.0) for t in active)
            if cons <= eps:
                continue
            dt = (cap - used[r]) / cons
            if dt < t_res:
                t_res, lim_r = dt, r
        # time until a tenant is fully satisfied (scale reaches 1)
        t_sat, sat_t = float("inf"), None
        for t in active:
            dt = (1.0 - scale[t]) / rate[t]
            if dt < t_sat:
                t_sat, sat_t = dt, t
        dt = min(t_res, t_sat)
        if dt == float("inf") or dt < 0:
            break
        for t in active:
            scale[t] += rate[t] * dt
        for r in capacities:
            used[r] += dt * sum(rate[t] * demands[t].get(r, 0.0)
                                for t in active)
        if t_sat <= t_res and sat_t is not None:
            scale[sat_t] = min(scale[sat_t], 1.0)
            active.discard(sat_t)
        if t_res <= t_sat and lim_r is not None:
            used[lim_r] = capacities[lim_r]
            # tenants that demand the saturated resource stop growing
            active = {t for t in active
                      if demands[t].get(lim_r, 0.0) <= eps}

    alloc, dom_share = {}, {}
    for t in tenants:
        s = min(scale[t], 1.0)
        a = {r: s * v for r, v in demands[t].items()}
        a["__scale__"] = s
        alloc[t] = a
        dom_share[t] = s * dom_per_scale[t]
    return DRFResult(alloc=alloc, dominant=dom_res, dominant_share=dom_share)
