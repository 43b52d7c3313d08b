"""A 2-shard sim fleet consolidating 4 bursty tenants (SuperNIC §2 + §5),
on the port.  The fleet is simulated on the host; it prints the same
numbers as the JAX package's walkthrough (``examples/sharded_rack.py``).

Four tenants offer phase-shifted bursty loads (a
``consolidation.synthetic_trace`` modulated by alternating burst windows:
t0/t2 burst in the even windows, t1/t3 in the odd ones).  They are deployed
through one ``Platform`` onto a ``ShardedBackend`` of two 100G sim sNICs:

  1. **Cold-start placement** spreads them least-loaded-first, which lands
     the two *correlated* tenants t0 and t2 on the same shard — their
     bursts stack to ~130G on a 100G shard.
  2. The placer's measured load histories (sampled from the per-tenant
     scheduler monitors every global epoch) flag the overload, and a
     **rebalance migration** (deploy-on-new-shard + drain-old) moves one of
     them in with the anti-correlated pair, where its bursts fill the other
     pair's silent windows.
  3. The fleet ends up provisioning the **peak of each shard's aggregate**
     instead of the sum of tenant peaks — the savings ratio of Figs 2-3,
     measured, not assumed.

Run:  PYTHONPATH=src python examples/torch/sharded_rack.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import _device
from repro_torch.api import Placer, Platform, ShardedBackend, SimBackend, \
    VPC_SPECS, nt
from repro_torch.core.consolidation import synthetic_trace

STEP_NS = 80_000.0          # one drive step = one global epoch window
T = 72                      # steps (~5.8 ms of simulated time)
PKT = 1500                  # bytes per injected packet


def build_loads() -> np.ndarray:
    """(4, T) Gbps: bursty synthetic traces, phase-shifted so t0 and t2
    burst together (even windows) while t1 and t3 burst in the odd ones —
    and t3 is a light tenant, so one shard has headroom to absorb a move."""
    base = synthetic_trace(4, T, seed=11, base=4.0, peak=14.0)
    win = (np.arange(T) // 8) % 2               # 8-step burst windows
    loads = np.zeros_like(base)
    phase = [0, 1, 0, 1]                        # t0/t2 even, t1/t3 odd
    amp = [44.0, 44.0, 44.0, 6.0]
    scale = [0.7, 0.7, 0.7, 0.25]
    for i in range(4):
        mask = (win == phase[i]).astype(float)
        loads[i] = scale[i] * base[i] * (0.15 + 0.85 * mask) + amp[i] * mask
    return loads


def main(device=None) -> None:
    # the walkthroughs' one convention: the card unless asked for the CPU
    # (the simulated fleet runs on the host either way)
    _device.resolve(device)
    loads = build_loads()
    names = [f"t{i}" for i in range(4)]
    peaks = loads.max(axis=1)
    print("=== offered load profiles (Gbps)")
    for i, t in enumerate(names):
        lane = "even" if i % 2 == 0 else "odd "
        print(f"  {t}: peak {peaks[i]:5.1f}  mean {loads[i].mean():5.1f}  "
              f"bursts in {lane} windows")
    print(f"  sum of tenant peaks: {peaks.sum():.1f} Gbps "
          f"(static per-tenant provisioning)\n")

    sb = ShardedBackend(
        [SimBackend(name="snicA"), SimBackend(name="snicB")],
        placer=Placer([100.0, 100.0], min_history=6),
        rebalance_every=2)
    plat = Platform(sb, specs=VPC_SPECS)
    chain = nt("firewall") >> nt("nat")
    deps = {t: plat.tenant(t).deploy(chain) for t in names}
    sb.settle()

    print("=== cold-start placement (no load history yet)")
    for d in sb.placer.decisions:
        print(f"  {d}")
    print()

    seen_migrations = 0
    for k in range(T):
        for i, t in enumerate(names):
            nbytes = loads[i, k] / 8.0 * STEP_NS        # Gb/s over one step
            for _ in range(int(nbytes // PKT)):
                deps[t].inject(PKT)
        plat.run(duration_ns=STEP_NS)
        if len(sb.migrations) > seen_migrations:
            for ep, src, dst, uid in sb.migrations[seen_migrations:]:
                t = sb.dags[uid].tenant
                print(f"=== epoch {ep}: shard peak-of-aggregate over "
                      f"capacity -> MIGRATE {t} (dag {uid}) {src} -> {dst}")
                print(f"  {sb.placer.decisions[-1]}\n")
            seen_migrations = len(sb.migrations)

    rep = plat.report()
    sav = rep.extra["consolidation"]
    print("=== final placement")
    for uid, shard in sorted(rep.extra["routes"].items()):
        print(f"  dag {uid} ({sb.dags[uid].tenant}) on {shard}")
    print("\n=== served (fleet)")
    for t in names:
        tr = rep[t]
        per = "  ".join(f"{s}:{v['gbps']:5.1f}G"
                        for s, v in sorted(tr.extra["per_shard"].items()))
        print(f"  {t}: {tr.gbps:5.1f} Gbps   [{per}]")
    print("\n=== consolidation economics (measured offered load)")
    print(f"  sum of tenant peaks : {sav['sum_of_peaks']:7.1f} Gbps")
    print(f"  per-shard peaks     : "
          + ", ".join(f"{p:.1f}" for p in sav['per_shard_peaks']))
    print(f"  fleet provisions    : {sav['sum_of_shard_peaks']:7.1f} Gbps")
    print(f"  savings ratio       : {sav['savings']:.2f}x "
          f"(ideal single pool: {sav['ideal_savings']:.2f}x)")
    assert sb.migrations, "expected at least one rebalance migration"
    assert sav["savings"] > 1.1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
