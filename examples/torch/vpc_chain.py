"""VPC NT chain (paper §6.2) through the port's offload API: the SAME
DAG — ``nt("firewall") >> nt("nat") >> nt("chacha20")`` — deploys
unmodified onto two substrates:

  - ComputeBackend: the chain fuses into one program, on the card one
    hand-written CUDA kernel (firewall/NAT/ChaCha20 in one pass), held
    bit for bit against the port's plain chain (``serving.vpc.vpc_chain``);
    the ciphertext is decrypted again by the stand-alone ChaCha20 kernel
    (``kernels.chacha20.ops.encrypt``);
  - SimBackend: the paper-constant sNIC device model (latency/Gbps stats).

  PYTHONPATH=src python examples/torch/vpc_chain.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch.api import ComputeBackend, Platform, SimBackend, VPC_SPECS, nt
from repro_torch.kernels.chacha20.ops import encrypt
from repro_torch.serving.vpc import make_packets, make_rules, vpc_chain

VPC = nt("firewall") >> nt("nat") >> nt("chacha20")


def run_compute(dev, n: int = 4096) -> None:
    print(f"== ComputeBackend: {VPC!r} as one fused program on {dev} ==")
    rules = make_rules(32, seed=2, device=dev)
    key = torch.from_numpy(np.arange(8, dtype=np.uint32) * 3 + 1).to(dev)
    nonce = torch.from_numpy(np.arange(3, dtype=np.uint32) + 7).to(dev)
    # the fused program is the default on the card; the CPU asks for it
    # (its wrapper then runs the kernel's plain version)
    plat = Platform(ComputeBackend(device=dev, use_fused=True),
                    specs=VPC_SPECS)
    dep = plat.tenant("acme").deploy(
        VPC, params={"firewall": {"rules": rules},
                     "nat": {"nat_ip": 0x0A000001},
                     "chacha20": {"key": key, "nonce": nonce}})
    headers, payload = make_packets(n, seed=1, device=dev)
    dep.inject(headers=headers, payload=payload)     # warm-up/build batch
    plat.run()
    t0 = time.time()
    reps = 5
    for _ in range(reps):
        dep.inject(headers=headers, payload=payload)
        plat.run()          # one dispatch + ONE device sync per run
    dt = (time.time() - t0) / reps
    assert plat.backend.stats["traces"] == 1, "bucket cache must hold"
    out = plat.report()["acme"].outputs[0]
    allow, newh, ct = vpc_chain(headers, payload, rules, key, nonce)
    assert torch.equal(out["allow"], allow)
    assert torch.equal(out["headers"], newh)
    assert torch.equal(out["payload"], ct)
    print(f"packets      : {n}")
    print(f"allowed      : {int(out['allow'].sum())}")
    print(f"fused chain  : {n / dt / 1e6:.2f} Mpkt/s "
          f"({n * 64 * 8 / dt / 1e9:.3f} Gbit/s payload)")
    # decryption round-trip proves the keystream
    pt = encrypt(out["payload"], key, nonce)
    ok = out["allow"].cpu().numpy()
    assert (pt.cpu().numpy()[ok] == payload.cpu().numpy()[ok]).all()
    print("bit-exact    : matches vpc_chain; ciphertext round-trips")


def run_sim(duration_ms: float = 4.0) -> None:
    print("== SimBackend: the same DAG on the sNIC device model ==")
    plat = Platform(SimBackend(), specs=VPC_SPECS)
    dep = plat.tenant("acme", weight=1.0).deploy(VPC)
    plat.backend.settle()       # let the pre-launch PR finish before traffic
    dep.source("poisson", rate_gbps=40.0, mean_bytes=1000, seed=1,
               duration_ms=duration_ms)
    plat.run(duration_ms=duration_ms)
    tr = plat.report()["acme"]
    print(f"packets      : {tr.pkts_done} done, {tr.drops} dropped")
    print(f"throughput   : {tr.gbps:.2f} Gbps")
    print(f"latency      : mean {tr.mean_latency_us:.2f} us, "
          f"p99 {tr.p99_latency_us:.2f} us")


def main(device=None, n: int = 4096, duration_ms: float = 4.0) -> None:
    dev = _device.resolve(device)
    run_compute(dev, n)
    print()
    run_sim(duration_ms)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
