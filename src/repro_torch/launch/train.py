"""End-to-end training driver on one card.

Runs a trainable architecture (full or ``tiny:`` reduced config) with the
port's substrate: the train step, checkpoint/restart, the synthetic data
stream, optional error-feedback gradient compression (int8 through the
hand-written quantize kernels on the card) and failure injection.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny:yi-6b \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck --device cpu

Without ``--device`` it runs on ``cuda:0`` and raises where there is no
GPU.  There is no mesh: ``--mesh`` takes only ``1x1`` (sharded training is
ROADMAP Queue 1 #7).  Fault tolerance: ``--crash-at N`` raises after step
N; rerunning the same command restores from the latest checkpoint and
continues from the step-indexed data stream.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import _device, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import (make_train_step, moment_dtype_for,
                                      value_and_grad)
from repro_torch.models import model as MD
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor


def get_cfg(name: str):
    if name.startswith("tiny:"):
        return configs.get_tiny_config(name[5:])
    return configs.get_config(name)


class Trainer:
    """Owns params, optimizer state, the step and the checkpoint manager.
    Weights are drawn on the device from ``seed``; the step updates them
    in place."""

    def __init__(self, cfg, ckpt_dir=None, *, lr=3e-4, compress="none",
                 seed=0, keep=3, device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.compressor = GradCompressor(compress)
        self.params = MD.init_params(seed, cfg, device=self.device)
        self.opt = adamw.init(self.params, moment_dtype_for(cfg))
        self.step_fn = self._build_step(lr)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir
                     else None)
        self.step = 0

    def _build_step(self, lr):
        if self.compressor.method == "none":
            base = make_train_step(self.cfg, lr=lr)

            def stepc(params, opt, ef, batch):
                p, o, m = base(params, opt, batch)
                return p, o, ef, m
            return stepc
        compressor = self.compressor

        def stepc(params, opt, ef, batch):
            # gradients of the f32 params, then the compression NT chain
            (_, m), grads = value_and_grad(params, self.cfg, batch)
            grads, ef, cm = compressor.compress(grads, ef)
            params, opt, om = adamw.update(grads, opt, params, lr=lr)
            return params, opt, ef, {**m, **om, **cm}
        return stepc

    # ----------------------------------------------------------- training --
    def restore_if_any(self) -> bool:
        if self.ckpt and self.ckpt.latest_step() is not None:
            tree = {"params": self.params, "opt": self.opt}
            restored, extra = self.ckpt.restore(None, tree)
            self.params, self.opt = restored["params"], restored["opt"]
            self.step = int(extra["step"])
            return True
        return False

    def run(self, steps: int, batch: int, seq: int, *, seed=0,
            ckpt_every=10, crash_at=None, log_every=10, log=print):
        data = SyntheticLM(self.cfg, batch, seq, seed=seed,
                           device=self.device)
        ef = self.compressor.init(self.params)
        losses = []
        t0 = time.time()
        while self.step < steps:
            b = data.batch(self.step)
            self.params, self.opt, ef, m = self.step_fn(
                self.params, self.opt, ef, b)
            self.step += 1
            # keep the loss on the device: converting every step would
            # block the launch queue once per step; the whole history
            # crosses to the host once at return
            losses.append(m["loss"])
            if self.step % log_every == 0 or self.step == steps:
                # the logging sync is deliberate, amortised over log_every
                log(f"step {self.step:5d} "
                    f"loss {float(m['loss']):.4f} "  # noqa: L-HOSTSYNC
                    f"gnorm {float(m['grad_norm']):.3f} "  # noqa: L-HOSTSYNC
                    f"({(time.time() - t0):.1f}s)")
            if self.ckpt and (self.step % ckpt_every == 0
                              or self.step == steps):
                self.ckpt.save(self.step,
                               {"params": self.params, "opt": self.opt},
                               extra={"step": self.step})
            if crash_at is not None and self.step >= crash_at:
                if self.ckpt:
                    self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {self.step}")
        if self.ckpt:
            self.ckpt.wait()
        if not losses:
            return []
        return torch.stack(losses).cpu().tolist()   # ONE device->host copy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny:yi-6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported; one card "
            "runs --mesh 1x1 (ROADMAP Queue 1 #7)")

    cfg = get_cfg(args.arch)
    tr = Trainer(cfg, args.ckpt, lr=args.lr, compress=args.compress,
                 seed=args.seed, device=args.device)
    if tr.restore_if_any():
        print(f"[train] restored from step {tr.step}")
    losses = tr.run(args.steps, args.batch, args.seq, seed=args.seed,
                    ckpt_every=args.ckpt_every, crash_at=args.crash_at)
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
