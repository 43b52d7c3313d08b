"""Quickstart on the port: train a tiny assigned-architecture model,
checkpoint it, and serve requests through the unified offload API — the
serving DAG ``nt("cache") >> nt("prefill") >> nt("decode")`` deployed on
ServeBackend (the SuperNIC-policy engine; dropping the cache NT disables
the response cache).  On the card, training and prefill run the
hand-written flash-attention kernel.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch import _device, configs
from repro_torch.api import Platform, ServeBackend, SERVE_SPECS, nt
from repro_torch.launch.train import Trainer
from repro_torch.serving.engine import EngineConfig


def main(device=None, steps: int = 20, batch: int = 8, seq: int = 64,
         requests: int = 6, max_new: int = 8) -> None:
    dev = _device.resolve(device)
    # tiny yi-6b at head dim 64, the smallest the attention kernel is built
    # for (the tiny config's own is 16)
    cfg = configs.get_tiny_config("yi-6b").replace(head_dim=64)

    # ------------------------------------------------------------- train --
    # one device, no mesh: what the JAX package's 1x1 mesh is (the port's
    # train CLI takes --mesh 1x1 the same way)
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt:
        tr = Trainer(cfg, ckpt, lr=1e-3, device=dev)
        print(f"== training tiny:yi-6b for {steps} steps on {dev} ==")
        losses = tr.run(steps=steps, batch=batch, seq=seq, ckpt_every=10)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert len(losses) == steps and np.isfinite(losses).all()

    # ------------------------------------------------------------- serve --
    print("== serving through the Platform API (cache NT in the DAG) ==")
    backend = ServeBackend(cfg, EngineConfig(batch_sizes=(1, 2), max_len=96),
                           params=tr.params, device=dev)
    plat = Platform(backend, specs=SERVE_SPECS)
    tenants = [plat.tenant(f"tenant{i}") for i in range(2)]
    deps = [t.deploy(nt("cache") >> nt("prefill") >> nt("decode"))
            for t in tenants]
    backend.prelaunch()   # paper's pre-launch: build before traffic
    rng = np.random.default_rng(0)
    reqs = [deps[i % 2].inject(
                rng.integers(2, cfg.vocab_size, 12).astype(np.int32),
                max_new=max_new) for i in range(requests)]
    plat.run()
    # resubmit the first prompt: served by the caching NT this time
    hit = deps[0].inject(reqs[0].prompt, max_new=max_new)
    plat.run()
    rep = plat.report()
    for r in reqs[:2] + [hit]:
        print(f"req {r.rid} tenant={r.tenant} cached={r.cached} "
              f"out={r.out}")
    print(f"cache NT: {rep.extra['cache_hits']} hits / "
          f"{rep.extra['cache_misses']} misses")
    print(f"compile log (PR analogue): "
          f"{[(k, bs, round(t, 2)) for k, bs, t in rep.extra['compile_log']]}")
    for t in tenants:
        tr_rep = rep.tenants.get(t.name)
        if tr_rep:
            print(f"{t.name}: {tr_rep.pkts_done} requests, "
                  f"mean latency {tr_rep.mean_latency_us / 1e3:.1f} ms")
    assert all(len(r.out) == max_new for r in reqs)
    assert hit.cached and hit.out == reqs[0].out
    assert rep.extra["cache_hits"] == 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
