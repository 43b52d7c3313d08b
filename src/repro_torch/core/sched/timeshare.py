"""Weighted deficit round-robin (WDRR) service order — fair time sharing.

Time sharing decides *which tenant is served next* once work is queued;
space sharing (DRF) decides *how much* each tenant may consume per epoch.
WDRR gives byte/token-granular weighted fairness with O(1) work per served
item: each round a queue earns ``quantum * weight`` of deficit and serves
head items while the deficit covers their cost.  Long-run service shares
converge to the weight ratio regardless of item sizes (Shreedhar &
Varghese, SIGCOMM'95), which is exactly the paper's fair-time-sharing
requirement for heterogeneous NT chains.

Ordering is deterministic but **never name-based**: the ring follows tenant
registration order and the deficit counters, so renaming a tenant cannot
change any admission or service outcome (the serving engine's old
``sorted(self.queues)`` alphabetical bias is the regression this guards
against).
"""
from __future__ import annotations

import math
from typing import Callable, Iterator

from .queues import COST_EPS, QueueItem, TenantQueue


class DeficitRoundRobin:
    """WDRR over an ordered ``{name: TenantQueue}`` mapping.

    The deficit counters live on the queues and persist across ``drain``
    calls, so fairness holds across service windows that stop mid-round
    (e.g. a serving epoch that admits only ``epoch_requests`` items).  A
    queue that goes empty forfeits its deficit (classic WDRR: idle tenants
    cannot hoard credit and burst later).
    """

    #: weights at/below zero are clamped to this: a weight-0 tenant is
    #: best-effort (served only once every positive-weight queue is idle),
    #: never a ZeroDivisionError
    MIN_WEIGHT = 1e-9

    def __init__(self, quantum: float = 1500.0):
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        #: deficit earned per round per unit weight; the natural unit is one
        #: typical item cost (an MTU of bytes, one request of tokens)
        self.quantum = quantum

    def drain(self, queues: dict[str, TenantQueue], *,
              gate: Callable[[TenantQueue, QueueItem], bool] | None = None,
              stop: Callable[[], bool] | None = None,
              ) -> Iterator[tuple[str, QueueItem]]:
        """Yield ``(tenant, item)`` in WDRR order, popping as it goes.

        ``gate(queue, item) -> bool``: a False verdict *parks* the queue for
        the rest of this drain (out of budget / credits) without consuming
        the item.  ``stop()`` ends the drain early (service window full).
        Queues empty or parked end the drain; with neither hook this is a
        full work-conserving drain in fair order.
        """
        parked: set[str] = set()
        while True:
            if stop is not None and stop():
                return
            ring = [n for n, q in queues.items() if len(q) and n not in parked]
            if not ring:
                return
            # Top up deficits with as many whole WDRR rounds as it takes for
            # at least one head to become affordable — skipping empty rounds
            # in one step keeps the drain O(served items), not O(rounds).
            shy = [max(0.0, q.head().cost - q.deficit)
                   / (self.quantum * max(q.weight, self.MIN_WEIGHT))
                   for q in (queues[n] for n in ring)]
            rounds = max(1, math.ceil(min(shy))) if min(shy) > 0 else 1
            for n in ring:
                q = queues[n]
                q.deficit += rounds * self.quantum \
                    * max(q.weight, self.MIN_WEIGHT)
            served_any = False
            for n in ring:
                q = queues[n]
                while len(q):
                    if stop is not None and stop():
                        return
                    item = q.head()
                    if q.deficit < item.cost - COST_EPS:
                        break
                    if gate is not None and not gate(q, item):
                        parked.add(n)
                        break
                    q.deficit -= item.cost
                    q.pop()
                    served_any = True
                    yield n, item
                if not len(q):
                    q.deficit = 0.0      # idle tenants forfeit credit
            if not served_any and all(
                    n in parked for n, q in queues.items() if len(q)):
                return                   # everything left is gated
