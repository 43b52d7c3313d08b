"""Heavy-tailed tenant populations: the skew every datacenter trace shows.

Tenant weights/sizes follow Zipf (a few tenants dominate), per-tenant
packet sizes follow bounded Pareto, and each tenant's network-task DAG is
drawn from a power-law mix over chain templates built from the existing
NT specs — so a generated fleet looks like the paper's workload section
(most tenants tiny, a heavy head, diverse chains) rather than N clones.
"""
from __future__ import annotations

import random

#: chain templates over the stock VPC NT specs, shortest first — the
#: power-law mix draws index 0 most often, so most tenants run the short
#: transport chains and a heavy tail runs the full crypto datapath
VPC_CHAIN_MIX: tuple[tuple[str, ...], ...] = (
    ("firewall",),
    ("firewall", "nat"),
    ("nat",),
    ("firewall", "nat", "chacha20"),
)

#: the serving substrate's canonical chains (see SERVE_SPECS)
SERVE_CHAIN_MIX: tuple[tuple[str, ...], ...] = (
    ("prefill", "decode"),
    ("cache", "prefill", "decode"),
)


def zipf_weights(n: int, s: float = 1.1) -> list[float]:
    """Zipf(s) tenant weights, normalized so the mean weight is 1.0 —
    rank-1 dominates, the tail is long.  Deterministic (no RNG)."""
    if n < 1:
        raise ValueError("need n >= 1 tenants")
    raw = [1.0 / (i + 1) ** s for i in range(n)]
    mean = sum(raw) / n
    return [round(w / mean, 6) for w in raw]


def pareto_sizes(rng: random.Random, n: int, alpha: float = 1.5,
                 lo: int = 200, hi: int = 1500) -> list[int]:
    """Bounded-Pareto packet sizes in bytes: mostly small, a heavy tail of
    near-MTU packets."""
    if alpha <= 0:
        raise ValueError("pareto alpha must be > 0")
    out = []
    for _ in range(n):
        u = rng.random()
        size = lo / max(1.0 - u, 1e-12) ** (1.0 / alpha)
        out.append(int(min(max(size, lo), hi)))
    return out


def dag_mix(rng: random.Random, n: int,
            templates: tuple[tuple[str, ...], ...] = VPC_CHAIN_MIX,
            alpha: float = 1.3) -> list[tuple[str, ...]]:
    """Draw ``n`` chains from a power-law mix over ``templates``: template
    ``i`` has mass ``1/(i+1)^alpha``, so early (short) templates dominate
    and the tail of tenants runs the long chains."""
    if not templates:
        raise ValueError("dag_mix needs >= 1 chain template")
    mass = [1.0 / (i + 1) ** alpha for i in range(len(templates))]
    total = sum(mass)
    out = []
    for _ in range(n):
        u = rng.random() * total
        acc = 0.0
        pick = len(templates) - 1
        for i, m in enumerate(mass):
            acc += m
            if u <= acc:
                pick = i
                break
        out.append(tuple(templates[pick]))
    return out


__all__ = ["VPC_CHAIN_MIX", "SERVE_CHAIN_MIX", "zipf_weights",
           "pareto_sizes", "dag_mix"]
