"""Two tenants with 3:1 weights sharing the VPC chain on two substrates,
on the port.

The same Platform API carries the tenant weight to the fair chain scheduler
(`core/sched/`) behind whichever backend is in front of it:

  - **SimBackend**: both tenants flood the 100G link at 3x capacity; the
    epoch-DRF ingress throttles converge the served Gbps to the 3:1 weights.
  - **ComputeBackend**: the heavy tenant queues its whole backlog before the
    light tenant injects anything, yet the WDRR drain interleaves dispatches
    so the light tenant is served early in weight proportion — not after the
    heavy tenant's entire queue.  On the card every dispatch group is one
    launch of the fused firewall/NAT/ChaCha20 kernel.

Run:  PYTHONPATH=src python examples/torch/multi_tenant.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.api import ComputeBackend, Platform, SimBackend, VPC_SPECS, nt
from repro_torch.serving.vpc import make_packets, make_rules

VPC = nt("firewall") >> nt("nat") >> nt("chacha20")
WEIGHTS = {"heavy": 3.0, "light": 1.0}


def on_sim(duration_ms: float = 4.0) -> float:
    """Both tenants at 3x the link; returns the served bytes heavy/light."""
    print("=== SimBackend: 3:1 weights, both tenants flooding 3x the link")
    plat = Platform(SimBackend(), specs=VPC_SPECS)
    deps = {t: plat.tenant(t, weight=w).deploy(VPC)
            for t, w in WEIGHTS.items()}
    plat.backend.settle()                      # let pre-launch PR finish
    for i, (t, dep) in enumerate(deps.items()):
        dep.source("poisson", rate_gbps=300.0, mean_bytes=1000,
                   seed=1 + i, duration_ms=duration_ms)
    plat.run(duration_ms=duration_ms)
    rep = plat.report()
    total = rep.total_gbps
    for t in WEIGHTS:
        tr = rep[t]
        print(f"  {t:6s} w={tr.extra['weight']:.0f}  {tr.gbps:6.2f} Gbps "
              f"({100 * tr.gbps / total:5.1f}% share)  "
              f"p99={tr.p99_latency_us:8.1f} us  drops={tr.drops}")
    ratio = rep['heavy'].bytes_done / rep['light'].bytes_done
    print(f"  served ratio heavy/light = {ratio:.2f} (weights say 3.00)\n")
    return ratio


def on_compute(dev, batch: int = 64, heavy: int = 30,
               light: int = 10) -> list:
    """The heavy tenant's backlog first, the light one's after; returns
    the heavy tenant's cumulative service share at each drain quarter."""
    print(f"=== ComputeBackend on {dev}: heavy tenant queues {heavy} "
          f"batches first, light {light} after")
    params = {"firewall": {"rules": make_rules(16, seed=2, device=dev)},
              "nat": {"nat_ip": 0x0A000001},
              "chacha20": {
                  "key": torch.from_numpy(
                      np.arange(8, dtype=np.uint32) * 3 + 1).to(dev),
                  "nonce": torch.from_numpy(
                      np.arange(3, dtype=np.uint32) + 7).to(dev)}}
    be = ComputeBackend(quantum_bytes=batch * (5 + 16) * 4, device=dev,
                        use_fused=True)
    plat = Platform(be, specs=VPC_SPECS)
    deps = {t: plat.tenant(t, weight=w).deploy(VPC, params=params)
            for t, w in WEIGHTS.items()}
    h, p = make_packets(batch, seed=3, device=dev)
    for _ in range(heavy):
        deps["heavy"].inject(headers=h, payload=p)
    for _ in range(light):
        deps["light"].inject(headers=h, payload=p)
    plat.run()
    rep = plat.report()
    # the fair drain order is where isolation shows: cumulative service
    # shares after each quarter of the dispatch stream
    log = be.dispatch_log
    total = sum(c for _, c in log)
    served = {t: 0.0 for t in WEIGHTS}
    marks, acc, shares = [0.25, 0.5, 0.75, 1.0], 0.0, []
    print("  service-order share (heavy%) at drain quarters:", end=" ")
    for t, cost in log:
        served[t] += cost
        acc += cost
        while marks and acc >= marks[0] * total - 1e-9:
            shares.append(served["heavy"] / acc)
            print(f"{100 * shares[-1]:.0f}%", end=" ")
            marks.pop(0)
    print(f"\n  ({heavy}/{heavy + light} batches are heavy: FIFO would "
          "start at 100% and starve light; WDRR holds ~75%)")
    total_pkts = rep.total_pkts
    for t in WEIGHTS:
        tr = rep[t]
        print(f"  {t:6s} w={tr.extra['weight']:.0f}  pkts={tr.pkts_done:5d}"
              f" ({100 * tr.pkts_done / total_pkts:5.1f}% of run)  "
              f"{tr.gbps:.3f} Gbps")
    print()
    assert total_pkts == (heavy + light) * batch, "every packet served"
    return shares


def main(device=None, duration_ms: float = 4.0, batch: int = 64,
         heavy: int = 30, light: int = 10) -> None:
    dev = _device.resolve(device)
    ratio = on_sim(duration_ms)
    shares = on_compute(dev, batch, heavy, light)
    # the 3 : 1 weights on both substrates: the sim's served bytes (the
    # epoch-DRF throttles reach the weights' split within 4 ms of simulated
    # time; before that, heavy already gets more), and the compute drain
    # order, which never gives heavy more than 80 % of a prefix of the
    # stream (FIFO: 100 % until its backlog is gone)
    assert ratio > 1.0, f"sim served ratio {ratio:.2f}, weights 3"
    if duration_ms >= 4.0:
        assert 2.5 < ratio < 3.5, f"sim served ratio {ratio:.2f}, weights 3"
    assert max(shares) <= 0.8 + 1e-9, f"light not served early: {shares}"


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
