"""Disaggregated KV-store case study (paper §6.1) on the port: YCSB over
Clio-like memory devices, with and without sNIC transport/caching/
replication NTs.  The store is simulated on the host; it prints the same
numbers as the JAX package's walkthrough (``examples/disaggregated_kv.py``).

  PYTHONPATH=src python examples/torch/disaggregated_kv.py [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import _device
from repro_torch.serving.kv_store import run_ycsb


def main(device=None, n_ops: int = 20000) -> None:
    # the walkthroughs' one convention: the card unless asked for the CPU
    # (the store's model runs on the host either way)
    _device.resolve(device)
    print(f"{'system':22s} {'wl':3s} {'avg us':>8s} {'p99 us':>8s} "
          f"{'kops':>8s} {'hit%':>6s}")
    for wl in ("A", "B", "C"):
        for system in ("clio", "clio-snic", "clio-snic-cache"):
            r = run_ycsb(system, workload=wl, n_ops=n_ops)
            hit = (f"{100 * r.hits / max(r.hits + r.misses, 1):.1f}"
                   if system.endswith("cache") else "-")
            print(f"{system:22s} {wl:3s} {r.avg_us:8.2f} {r.p99_us():8.2f} "
                  f"{r.kops(r.done_ns):8.1f} {hit:>6s}")
    print("\nreplicated writes (K=2):")
    for system in ("clio", "clio-snic-repl"):
        r = run_ycsb(system, workload="A", n_ops=n_ops, replication=2)
        print(f"{system:22s} A   {r.avg_us:8.2f} {r.p99_us():8.2f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
