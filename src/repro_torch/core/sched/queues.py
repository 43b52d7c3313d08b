"""Per-tenant ingress queues with byte/token credit accounting.

A :class:`TenantQueue` is the unit of isolation: it holds one tenant's
pending work in arrival order, enforces a backlog cap (drops are counted,
never silent), paces departures with a token bucket whose rate is set by the
space-sharing control loop (DRF grants -> ingress throttles), and carries
the per-tenant monitors (served cost/items, drops, WDRR deficit) every
substrate reports from.

``cost`` is the scalar credit currency — wire bytes on the packet
substrates, tokens on the serving substrate.  ``costs`` optionally carries
the full multi-resource demand vector (e.g. ``{"tokens": 96, "pages": 7}``)
so epoch DRF can see every dimension of standing backlog.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

#: float token accumulation can sit one ulp below the head cost forever
#: (a retry delay that rounds below the clock resolution would spin the
#: event loop at one timestamp) — everything credit-gated compares with
#: this epsilon
COST_EPS = 1e-6


@dataclass
class QueueItem:
    payload: object
    cost: float
    costs: dict[str, float] | None = None
    enqueued_at: float = 0.0


@dataclass
class TenantQueue:
    """One tenant's paced ingress queue + accounting monitors."""

    name: str
    weight: float = 1.0
    #: drop arrivals once the queued cost would exceed this (None = no cap)
    max_backlog: float | None = None
    #: token-bucket depth, expressed in time units of credit at the current
    #: rate (the sNIC uses 2 DRF epochs); 0 disables the depth cap
    bucket_window: float = 0.0
    #: clamp for credit-wait retry delays (the sNIC uses [16 ns, epoch])
    min_retry: float = 0.0
    max_retry: float = math.inf

    items: deque = field(default_factory=deque)
    backlog_cost: float = 0.0
    # token bucket (cost units; inf = unpaced)
    rate: float = math.inf
    tokens: float = math.inf
    last_refill: float = 0.0
    # monitors
    drops: int = 0
    #: cost accepted into the queue (drops excluded); the conservation law
    #: the sanitizer checks is granted == served + backlog.  push_front does
    #: NOT add here: a requeue pairs with a pop whose served_cost the
    #: scheduler reverses, so the law already balances.
    granted_cost: float = 0.0
    served_cost: float = 0.0
    served_items: int = 0
    #: WDRR deficit counter (owned by timeshare.DeficitRoundRobin)
    deficit: float = 0.0

    def __len__(self) -> int:
        return len(self.items)

    # ------------------------------------------------------------ ingress --
    def push(self, payload, cost: float, costs: dict | None = None,
             now: float = 0.0) -> bool:
        """Enqueue at the tail; False = dropped on the backlog cap."""
        if self.max_backlog is not None and \
                self.backlog_cost + cost > self.max_backlog:
            self.drops += 1
            return False
        self.items.append(QueueItem(payload, cost, costs, now))
        self.backlog_cost += cost
        self.granted_cost += cost
        return True

    def push_front(self, payload, cost: float, costs: dict | None = None,
                   now: float = 0.0) -> None:
        """Head-of-line requeue (e.g. admitted but out of memory); never
        dropped — the work was already accepted once."""
        self.items.appendleft(QueueItem(payload, cost, costs, now))
        self.backlog_cost += cost

    def shed(self, cost_limit: float) -> tuple[int, float]:
        """Backpressure: drop from the TAIL until the standing backlog is
        within ``cost_limit`` (newest work goes first — the head kept its
        place in line).  Both ``backlog_cost`` and ``granted_cost`` shrink
        by the shed cost, so the credit conservation law
        (granted == served + backlog) holds through a shed; drops are
        counted, never silent.  Returns ``(items, cost)`` shed."""
        n, cost = 0, 0.0
        while self.items and self.backlog_cost > cost_limit + COST_EPS:
            item = self.items.pop()
            self.backlog_cost -= item.cost
            self.granted_cost -= item.cost
            self.drops += 1
            n += 1
            cost += item.cost
        return n, cost

    def head(self) -> QueueItem | None:
        return self.items[0] if self.items else None

    def pop(self) -> QueueItem:
        item = self.items.popleft()
        self.backlog_cost -= item.cost
        self.served_cost += item.cost
        self.served_items += 1
        return item

    # ------------------------------------------------------ token credits --
    def set_rate(self, rate: float, now: float) -> None:
        """Apply a new pacing rate (cost units per time unit).  Credits the
        elapsed window at the *old* rate first, so a mid-window change never
        retroactively re-prices time already spent."""
        self.refill(now)
        self.rate = rate

    def refill(self, now: float) -> None:
        if self.rate is math.inf:
            self.tokens = math.inf
            self.last_refill = now
            return
        cap = (self.rate * self.bucket_window if self.bucket_window > 0
               else math.inf)
        if self.tokens is math.inf:          # switching from unpaced
            self.tokens = min(cap, self.rate * self.bucket_window) \
                if self.bucket_window > 0 else 0.0
        else:
            self.tokens = min(cap, self.tokens
                              + self.rate * (now - self.last_refill))
        self.last_refill = now

    def _due(self, cost: float) -> float:
        """Credits the head must show before leaving: its cost, except an
        item larger than the whole bucket departs on a full bucket (classic
        burst semantics) — otherwise it could never accrue enough and would
        park the queue forever."""
        cap = (self.rate * self.bucket_window if self.bucket_window > 0
               else math.inf)
        return min(cost, cap) if cap > 0 else cost

    def ready(self, now: float) -> bool:
        """True when the head item's cost is covered by current credits."""
        if not self.items:
            return False
        self.refill(now)
        return self.tokens >= self._due(self.items[0].cost) - COST_EPS

    def spend(self, cost: float) -> None:
        if self.tokens is not math.inf:
            self.tokens = max(0.0, self.tokens - cost)

    def retry_delay(self, now: float) -> float:
        """How long until the head could afford to leave (clamped)."""
        self.refill(now)
        need = self._due(self.items[0].cost) - self.tokens \
            if self.items else 0.0
        delay = need / self.rate if self.rate > 0 else self.max_retry
        return max(min(delay, self.max_retry), self.min_retry)

    # --------------------------------------------------------- monitoring --
    def backlog_costs(self) -> dict[str, float]:
        """Standing backlog as a multi-resource demand vector (items with no
        explicit vector contribute their scalar cost as ``"cost"``)."""
        out: dict[str, float] = {}
        for item in self.items:
            vec = item.costs if item.costs is not None \
                else {"cost": item.cost}
            for r, v in vec.items():
                out[r] = out.get(r, 0.0) + v
        return out
