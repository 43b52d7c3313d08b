"""Fault tolerance on the port: a training job is killed mid-run (simulated
node failure) and restarted — it restores the latest atomic checkpoint and
continues with the same data (step-indexed pipeline).

  PYTHONPATH=src python examples/torch/fault_tolerance.py [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch import _device, configs
from repro_torch.launch.train import Trainer

CKPT_EVERY = 5


def main(device=None, steps: int = 20, crash_at: int = 12, batch: int = 4,
         seq: int = 64) -> None:
    dev = _device.resolve(device)
    # tiny qwen3-8b at head dim 64, the smallest the attention kernel is
    # built for (the tiny config's own is 16)
    cfg = configs.get_tiny_config("qwen3-8b").replace(head_dim=64)
    with tempfile.TemporaryDirectory(prefix="ft_demo_") as ckpt:
        print(f"== run 1: crash injected at step {crash_at} ==")
        tr = Trainer(cfg, ckpt, lr=1e-3, device=dev)
        try:
            tr.run(steps=steps, batch=batch, seq=seq, ckpt_every=CKPT_EVERY,
                   crash_at=crash_at)
            raise AssertionError("the injected crash did not happen")
        except RuntimeError as e:
            print(f"   !! {e}")

        print("== run 2: restart (same command line) ==")
        tr2 = Trainer(cfg, ckpt, lr=1e-3, device=dev)
        restored = tr2.restore_if_any()
        print(f"   restored={restored} at step {tr2.step}")
        assert restored and tr2.step == crash_at // CKPT_EVERY * CKPT_EVERY
        losses = tr2.run(steps=steps, batch=batch, seq=seq,
                         ckpt_every=CKPT_EVERY)
    print(f"   completed to step {tr2.step}; final loss {losses[-1]:.4f}")
    assert tr2.step == steps and np.isfinite(losses).all()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    main(ap.parse_args().device)
