"""End-to-end serving on the port: a ~15M-parameter model (reduced
qwen3 family) serving batched multi-tenant requests through the full sNIC
policy stack — DRF admission, caching NT, batch-shape autoscaling, KV page
accounting.  On the card, prefill attention is the hand-written flash
kernel.

  PYTHONPATH=src python examples/torch/serve_e2e.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import _device, configs
from repro_torch.serving.engine import Engine, EngineConfig


def main(device=None, n_layers: int = 4, requests: int = 12,
         max_new: int = 12) -> None:
    dev = _device.resolve(device)
    # ~15M params: a real (small) transformer, not a toy shape.  The JAX
    # package's walkthrough has 8 query and 4 KV heads of 32; the attention
    # kernel is built for head dims 64, 128 and 160, so here 4 and 2 heads
    # of 64: the same widths (256 and 128) and parameter count
    cfg = configs.get_config("qwen3-8b").replace(
        n_layers=n_layers, d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=1024, vocab_size=8192, scan_layers=False,
        compute_dtype="float32", attn_block=64, loss_chunk=64)
    n = cfg.param_counts()["total"]
    print(f"model: {n / 1e6:.1f} M params")
    eng = Engine(cfg, EngineConfig(batch_sizes=(1, 2, 4), max_len=96,
                                   epoch_requests=6),
                 seed=0, tenant_weights={"gold": 2.0, "free": 1.0},
                 device=dev)
    t0 = time.time()
    eng.prelaunch()
    print(f"pre-launch (build all shapes): {time.time() - t0:.1f}s")

    rng = np.random.default_rng(1)
    reqs = []
    for i in range(requests):
        tenant = "gold" if i % 3 == 0 else "free"
        prompt = rng.integers(2, cfg.vocab_size,
                              rng.integers(8, 24)).astype(np.int32)
        reqs.append(eng.submit(tenant, prompt, max_new=max_new))
    t0 = time.time()
    eng.run_until_drained()
    # a repeated prompt exercises the caching NT
    eng.submit("free", reqs[0].prompt, max_new=max_new)
    eng.run_until_drained()
    dt = time.time() - t0
    done = eng.done
    toks = sum(len(r.out) for r in done)
    lat = [r.latency for r in done if not r.cached]
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s)")
    print(f"mean latency {np.mean(lat) * 1e3:.0f} ms; "
          f"cache hits {eng.cache_nt.hits}; "
          f"final batch shape {eng.active_bs}")
    by_tenant: dict = {}
    for r in done:
        by_tenant.setdefault(r.tenant, 0)
        by_tenant[r.tenant] += 1
    print(f"per-tenant completions: {by_tenant}")
    assert len(done) == requests + 1 and eng.cache_nt.hits == 1
    assert all(len(r.out) == max_new for r in done)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
