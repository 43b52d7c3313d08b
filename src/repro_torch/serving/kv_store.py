"""Disaggregated key-value store case study (paper §6.1, Figures 8-10).

Clients access Clio-like disaggregated memory devices through an sNIC.
Four systems, matching the paper's comparison:

  - ``clio``            : client -> ToR -> Clio device (no sNIC); Go-Back-N
                          transport runs on the device.
  - ``clio-snic``       : Go-Back-N offloaded to the sNIC; device keeps a
                          lightweight reliable link layer.
  - ``clio-snic-cache`` : + caching NT at the sNIC (FIFO over hot KVs);
                          hits skip the slow (10 Gbps) device link entirely.
  - ``clio-snic-repl``  : replication NT — client sends one write, the sNIC
                          fans out K copies to K devices in parallel.

Latency model uses the paper's measured constants (sNIC datapath 1.3 us,
core 196 ns, commodity switch ~0.9 us, Clio device ~2.5 us processing,
100 Gbps links everywhere except 10 Gbps Clio NICs — §7.1).  The cache and
replication logic is real (keys, FIFO eviction, YCSB zipf accesses); only
time is simulated.
"""
from __future__ import annotations

import math
import random
from collections import OrderedDict
from dataclasses import dataclass, field

from repro_torch.core.sim import GBPS, PAPER, US, EventSim

SWITCH_NS = 900.0          # commodity ToR latency (§7.2.1)
CLIO_PROC_NS = 2500.0      # Clio-side KV lookup/processing
CLIENT_STACK_NS = 1500.0   # client software + NIC
SNIC_PATH_NS = PAPER.FULL_PATH_NS
CACHE_LOOKUP_NS = 300.0    # caching NT lookup on sNIC
CLIO_LINK_GBPS = 10.0      # ZCU106 boards are 10 Gbps (§7.1)
HOST_LINK_GBPS = 100.0


def zipf_keys(n_keys: int, n_ops: int, theta: float = 0.99, seed: int = 0):
    """YCSB's zipfian generator (approximate, rank-based)."""
    rng = random.Random(seed)
    # standard zipf CDF sampling over ranks
    harm = [0.0] * (n_keys + 1)
    for i in range(1, n_keys + 1):
        harm[i] = harm[i - 1] + 1.0 / (i ** theta)
    total = harm[n_keys]
    keys = []
    for _ in range(n_ops):
        u = rng.random() * total
        lo, hi = 1, n_keys
        while lo < hi:
            mid = (lo + hi) // 2
            if harm[mid] < u:
                lo = mid + 1
            else:
                hi = mid
        keys.append(lo - 1)
    return keys


@dataclass
class Link:
    """Serialization + propagation server."""
    gbps: float
    prop_ns: float = 100.0
    busy_until: float = 0.0

    def xfer(self, now: float, nbytes: int) -> float:
        start = max(now, self.busy_until)
        self.busy_until = start + nbytes / (self.gbps * GBPS)
        return self.busy_until + self.prop_ns


@dataclass
class KVResult:
    latencies_us: list = field(default_factory=list)
    hits: int = 0
    misses: int = 0
    done_ns: float = 0.0

    @property
    def avg_us(self) -> float:
        return sum(self.latencies_us) / max(len(self.latencies_us), 1)

    def p99_us(self) -> float:
        s = sorted(self.latencies_us)
        return s[min(len(s) - 1, int(0.99 * len(s)))] if s else 0.0

    def kops(self, dur_ns: float) -> float:
        return len(self.latencies_us) / (dur_ns / 1e9) / 1e3


def run_ycsb(system: str, *, workload: str = "A", n_keys: int = 100_000,
             n_ops: int = 100_000, value_bytes: int = 1024,
             cache_entries: int = 4096, n_clients: int = 16,
             replication: int = 1, n_devices: int = 2,
             seed: int = 0) -> KVResult:
    """Closed-loop YCSB over one of the four systems."""
    get_frac = {"A": 0.5, "B": 0.95, "C": 1.0}[workload]
    rng = random.Random(seed + 1)
    keys = zipf_keys(n_keys, n_ops, seed=seed)
    is_get = [rng.random() < get_frac for _ in range(n_ops)]

    sim = EventSim()
    res = KVResult()
    cache: OrderedDict[int, bool] = OrderedDict()
    client_link = Link(HOST_LINK_GBPS)
    device_links = [Link(CLIO_LINK_GBPS) for _ in range(n_devices)]
    snic_up = Link(HOST_LINK_GBPS)

    req_bytes = 64
    resp_bytes = value_bytes + 64
    op_i = [0]

    def issue():
        i = op_i[0]
        if i >= n_ops:
            return
        op_i[0] += 1
        key = keys[i]
        get = is_get[i]
        dev = key % n_devices
        t0 = sim.now

        def finish():
            res.latencies_us.append((sim.now - t0) / US)
            res.done_ns = sim.now
            issue()

        # ---- client -> ToR (writes always carry ONE copy of the value;
        # client-side replication pays the extra copies on its own link) ----
        t = client_link.xfer(sim.now,
                             req_bytes if get else req_bytes + value_bytes)
        t += CLIENT_STACK_NS + SWITCH_NS

        if system == "clio":
            # ToR -> device (10G), Go-Back-N on device, response back
            t = device_links[dev].xfer(
                t, req_bytes if get else req_bytes + value_bytes) \
                + CLIO_PROC_NS
            size_back = resp_bytes if get else 64
            t = device_links[dev].xfer(t, size_back) + SWITCH_NS \
                + CLIENT_STACK_NS
            if not get and replication > 1:
                # chain replication via the primary (§6.1): primary forwards
                # the value to each secondary over its 10G link, then acks —
                # the added device-to-device round trips serialize.
                for rdev in range(1, replication):
                    d = (dev + rdev) % n_devices
                    t = device_links[dev].xfer(t, req_bytes + value_bytes)
                    t = device_links[d].xfer(t + SWITCH_NS,
                                             req_bytes + value_bytes) \
                        + CLIO_PROC_NS
                    t = device_links[d].xfer(t, 64) + SWITCH_NS
            sim.at(t, finish)
            return

        # ---- sNIC systems: ToR -> sNIC ----
        t += SNIC_PATH_NS / 2                      # ingress PHY/MAC + core
        if system == "clio-snic-cache" and get:
            t += CACHE_LOOKUP_NS
            if key in cache:
                cache.move_to_end(key)
                res.hits += 1
                t = snic_up.xfer(t, resp_bytes) + SNIC_PATH_NS / 2 \
                    + SWITCH_NS + CLIENT_STACK_NS
                sim.at(t, finish)
                return
            res.misses += 1

        # transport NT (Go-Back-N) on sNIC, then the device link
        t += PAPER.SNIC_CORE_NS
        if not get and (system == "clio-snic-repl" or replication > 1):
            # replication NT: fan out K copies in parallel from the sNIC
            ts = []
            for rdev in range(replication):
                d = (dev + rdev) % n_devices
                td = device_links[d].xfer(t, req_bytes + value_bytes) \
                    + CLIO_PROC_NS
                td = device_links[d].xfer(td, 64)
                ts.append(td)
            t = max(ts)
        else:
            t = device_links[dev].xfer(
                t, req_bytes if get else req_bytes + value_bytes) \
                + CLIO_PROC_NS
            t = device_links[dev].xfer(t, resp_bytes if get else 64)
        if system == "clio-snic-cache":
            if key not in cache and len(cache) >= cache_entries:
                cache.popitem(last=False)          # FIFO (paper §6.1)
            cache[key] = True
        t += SNIC_PATH_NS / 2 + SWITCH_NS + CLIENT_STACK_NS
        sim.at(t, finish)

    for _ in range(n_clients):
        issue()
    sim.run()
    return res
