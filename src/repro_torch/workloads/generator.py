"""generate(): tie arrivals + population + churn into one sealed Trace.

One call, one seed, one :class:`~repro_torch.workloads.trace.Trace`: tenant
weights come from Zipf, packet sizes from bounded Pareto, chains from a
power-law DAG mix over the NT-spec templates, per-epoch arrival counts
from a seeded Poisson sample of each tenant's rate process, and an
optional churn fraction staggers join/leave epochs across the horizon.
The result is pure data — regenerate with the same arguments and the
fingerprint matches bit-for-bit.
"""
from __future__ import annotations

import random
from typing import Callable

from .arrivals import Arrival, constant, sample_poisson
from .population import (VPC_CHAIN_MIX, dag_mix, pareto_sizes,
                         zipf_weights)
from .trace import Trace, TraceTenant


def generate(name: str, *, seed: int, epochs: int, n_tenants: int,
             arrival: Arrival | Callable[[int, random.Random], Arrival]
             | None = None,
             templates: tuple[tuple[str, ...], ...] = VPC_CHAIN_MIX,
             zipf_s: float = 1.1, pareto_alpha: float = 1.5,
             pkt_lo: int = 200, pkt_hi: int = 1500,
             churn_frac: float = 0.0,
             epoch_ns: float | None = None) -> Trace:
    """Generate a sealed scenario trace.

    ``arrival`` is either one :class:`Arrival` shape shared by the whole
    fleet (each tenant's rate is the shape scaled by its Zipf weight), or
    a factory ``f(tenant_index, rng) -> Arrival`` for per-tenant shapes
    (e.g. a flash crowd landing on tenant 0 only).  ``churn_frac`` of the
    population gets a staggered ``join_epoch``/``leave_epoch`` drawn
    inside the horizon; the rest live end-to-end.
    """
    if epochs < 1 or n_tenants < 1:
        raise ValueError("need epochs >= 1 and n_tenants >= 1")
    if not 0.0 <= churn_frac <= 1.0:
        raise ValueError("churn_frac must be in [0, 1]")

    rng = random.Random(f"trace:{name}:{seed}")
    weights = zipf_weights(n_tenants, s=zipf_s)
    sizes = pareto_sizes(rng, n_tenants, alpha=pareto_alpha,
                         lo=pkt_lo, hi=pkt_hi)
    chains = dag_mix(rng, n_tenants, templates=templates)

    tenants: list[TraceTenant] = []
    n_churn = int(round(churn_frac * n_tenants))
    for i in range(n_tenants):
        join, leave = 0, None
        # churn the *tail* of the Zipf ranking: the heavy head is the
        # stable base load, small tenants come and go (the paper's §2
        # dynamism argument)
        if n_churn and i >= n_tenants - n_churn and epochs >= 4:
            join = rng.randrange(1, max(2, epochs // 2))
            if rng.random() < 0.5:
                leave = rng.randrange(join + 2, epochs + 1)
        tenants.append(TraceTenant(
            name=f"t{i:03d}", weight=weights[i], chain=chains[i],
            pkt_bytes=sizes[i], join_epoch=join, leave_epoch=leave))

    shared = arrival if isinstance(arrival, Arrival) else None
    if arrival is None:
        shared = constant(20.0)

    events: list[tuple[int, str, int]] = []
    for i, t in enumerate(tenants):
        if shared is not None:
            shape: Arrival = shared
            scale = t.weight
        else:
            shape = arrival(i, random.Random(f"shape:{name}:{seed}:{i}"))
            scale = 1.0
        trng = random.Random(f"events:{name}:{seed}:{t.name}")
        for e in range(epochs):
            if not t.live_at(e):
                continue
            n = sample_poisson(trng, shape(e) * scale)
            if n > 0:
                events.append((e, t.name, n))

    return Trace(name=name, seed=seed, epochs=epochs, tenants=tenants,
                 events=events, epoch_ns=epoch_ns)


__all__ = ["generate"]
