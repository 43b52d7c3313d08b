"""Deterministic discrete-event simulation kernel + traffic sources.

All times are nanoseconds (float).  Every stochastic source takes an explicit
seed, so paper-figure benchmarks are bit-reproducible.

Paper timing constants (§4, §7) are collected in ``PaperConstants`` and used
by the sNIC device model and the figure benchmarks.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field

US = 1_000.0
MS = 1_000_000.0
SEC = 1_000_000_000.0
GBPS = 1e9 / 8 / SEC            # bytes per ns at 1 Gb/s


@dataclass(frozen=True)
class PaperConstants:
    LINK_GBPS: float = 100.0
    SNIC_CORE_NS: float = 196.0        # sNIC core datapath (§7.2.1)
    FULL_PATH_NS: float = 1300.0       # PHY+MAC+core+MAC+PHY (§7.2.1)
    SCHED_NS: float = 64.0             # scheduler fixed delay (16 cyc @250MHz)
    SYNC_NS: float = 16.0              # synchronization buffer (4 cycles)
    PR_NS: float = 5.0 * MS            # partial reconfiguration (§4.3)
    EPOCH_NS: float = 20.0 * US        # EPOCH_LEN (§4.4)
    DRF_NS: float = 3.0 * US           # DRF solver runtime (§4.4)
    MONITOR_NS: float = 10.0 * MS      # MONITOR_PERIOD (§4.4)
    REMOTE_LAUNCH_NS: float = 2.3 * US # remote NT launch control (§7.1.4)
    REMOTE_HOP_NS: float = 1.3 * US    # extra latency via remote sNIC (§7.1.4)
    PAGE_SWAP_NS: float = 17.5 * US    # 2MB page swap (§4.4: 15-20us)
    CREDITS: int = 8                   # reaches 100 Gbps (Fig 14)
    HEADER_BYTES: int = 64

PAPER = PaperConstants()


class EventSim:
    """Binary-heap event loop with stable FIFO tie-breaking."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self.now: float = 0.0

    def at(self, t_ns: float, fn, *args) -> None:
        heapq.heappush(self._heap, (t_ns, next(self._seq), fn, args))

    def after(self, delay_ns: float, fn, *args) -> None:
        self.at(self.now + delay_ns, fn, *args)

    def run(self, until_ns: float = math.inf, max_events: int = 50_000_000):
        """Process events with timestamp <= ``until_ns``, then advance the
        clock to ``min(until_ns, next-event-time)`` — an idle window (or one
        whose remaining events all lie past the horizon) still moves ``now``
        to the horizon, so measurement windows span exactly what was asked
        for."""
        n = 0
        while self._heap and n < max_events:
            t, _, fn, args = self._heap[0]
            if t > until_ns:
                break
            heapq.heappop(self._heap)
            self.now = max(self.now, t)
            fn(*args)
            n += 1
        if self._heap and self._heap[0][0] <= until_ns:
            return n          # stopped on the event budget: clock stays at
                              # the last event actually processed
        horizon = min(until_ns, self._heap[0][0]) if self._heap else until_ns
        if math.isfinite(horizon):
            self.now = max(self.now, horizon)
        return n


# ================================================================ sources ====
@dataclass
class FlowStats:
    latencies_ns: list = field(default_factory=list)
    bytes_done: float = 0.0
    pkts_done: int = 0
    drops: int = 0

    def mean_latency_us(self) -> float:
        if not self.latencies_ns:
            return 0.0
        return sum(self.latencies_ns) / len(self.latencies_ns) / US

    def p99_us(self) -> float:
        if not self.latencies_ns:
            return 0.0
        s = sorted(self.latencies_ns)
        return s[min(len(s) - 1, int(0.99 * len(s)))] / US

    def gbps(self, dur_ns: float) -> float:
        return self.bytes_done / max(dur_ns, 1.0) / GBPS


def poisson_source(sim: EventSim, *, rate_gbps: float, mean_bytes: int,
                   tenant: str, dag_uid: int, sink, seed: int = 0,
                   until_ns: float = math.inf, min_bytes: int = 64,
                   start_ns: float = 0.0):
    """Open-loop Poisson arrivals with exponential sizes (mean ``mean_bytes``)."""
    rng = random.Random(seed)
    bytes_per_ns = rate_gbps * GBPS

    def emit():
        if sim.now >= until_ns:
            return
        size = max(min_bytes, int(rng.expovariate(1.0 / mean_bytes)))
        sink(tenant, dag_uid, size)
        gap = rng.expovariate(bytes_per_ns / max(size, 1))
        sim.after(gap, emit)

    sim.at(start_ns, emit)


def fb_kv_source(sim: EventSim, *, tenant: str, dag_uid: int, sink,
                 seed: int = 0, scale: float = 1.0,
                 until_ns: float = math.inf, start_ns: float = 0.0):
    """Facebook 2012 KV-trace-like traffic (Atikoglu et al., SIGMETRICS'12):
    generalized-Pareto inter-arrivals (bursty) and a bimodal size mix of
    small GETs and larger SETs.  ``scale`` multiplies the mean offered load.
    Median/95p loads land near the paper's 24/32 Gbps per endhost at scale=1.
    """
    rng = random.Random(seed)
    # GP(k=0.1, sigma) inter-arrivals; sigma tuned for ~24 Gbps median load
    k, sigma = 0.1, 260.0 / max(scale, 1e-9)

    def gp_gap():
        u = max(rng.random(), 1e-12)
        return sigma / k * ((u ** -k) - 1.0)

    def size():
        r = rng.random()
        if r < 0.7:
            return max(64, int(rng.lognormvariate(math.log(280), 0.6)))
        if r < 0.97:
            return max(64, int(rng.lognormvariate(math.log(1200), 0.5)))
        return max(64, int(rng.lognormvariate(math.log(8000), 0.8)))

    def emit():
        if sim.now >= until_ns:
            return
        sink(tenant, dag_uid, size())
        sim.after(gp_gap(), emit)

    sim.at(start_ns, emit)


def onoff_source(sim: EventSim, *, tenant: str, dag_uid: int, sink,
                 peak_gbps: float, duty: float = 0.2, period_ns: float = 2 * MS,
                 mean_bytes: int = 1024, seed: int = 0,
                 until_ns: float = math.inf, start_ns: float = 0.0,
                 phase: float = 0.0):
    """Bursty on/off traffic: ``peak_gbps`` during the ON fraction ``duty`` of
    every ``period_ns``; silent otherwise.  Models Fig 2/3's fluctuating loads
    whose peaks do not align across endpoints (``phase`` shifts the window)."""
    rng = random.Random(seed)
    bpns = peak_gbps * GBPS

    def emit():
        if sim.now >= until_ns:
            return
        t = (sim.now + phase * period_ns) % period_ns
        if t < duty * period_ns:
            size = max(64, int(rng.expovariate(1.0 / mean_bytes)))
            sink(tenant, dag_uid, size)
            sim.after(size / bpns, emit)
        else:
            # sleep to the next ON *start* (period boundary).  The old
            # ``duty*period + period - t`` delay lands exactly on the ON
            # window's END when the clock is boundary-aligned (t a multiple
            # of the period grid), parking the source in OFF forever.
            sim.after(period_ns - t, emit)

    sim.at(start_ns, emit)
