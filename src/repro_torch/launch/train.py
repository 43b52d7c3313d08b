"""End-to-end training driver, on one card or sharded over a mesh.

Runs a trainable architecture (full or ``tiny:`` reduced config) with the
port's substrate: the train step, checkpoint/restart, the synthetic data
stream, optional error-feedback gradient compression (int8 through the
hand-written quantize kernels on the card) and failure injection.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny:yi-6b \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch tiny:yi-6b --mesh 4x2 --device cpu

Without ``--device`` it runs on ``cuda:0`` and raises where there is no
GPU.  ``--mesh DxM`` / ``PxDxM`` other than ``1x1`` (or any mesh under
``torchrun``) trains sharded: the process group comes from the
``torchrun`` environment, NCCL on the card, gloo with ``--device cpu``.
Parameters, AdamW moments and the EF buffers are DTensors placed by the
rule table (``parallel.sharding.param_specs``) and each rank takes its
batch shard.  Each layer gathers its weights over the data axes as it
runs (FSDP style); for the configs whose rule tables shard over "model"
(tensor parallelism: qwen2.5-32b, grok-1-314b, jamba-v0.1-52b) each
"model" rank keeps its own shard of every TP weight and computes its own
heads, channels and experts (``models.model``), and with ``fsdp_only``
every weight is gathered whole.  Fault tolerance: ``--crash-at N``
raises after step N; rerunning the same command restores from the latest
checkpoint, on any mesh shape, and continues from the step-indexed data
stream.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch import _device, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM, place_microbatches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (make_train_step, moment_dtype_for,
                                      value_and_grad)
from repro_torch.models import model as MD
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as SH


def parse_mesh(spec: str):
    """"DxM" or "PxDxM" -> a ``DeviceMesh`` over the initialised process
    group (one larger than the group raises)."""
    parts = tuple(int(x) for x in spec.split("x"))
    if len(parts) not in (2, 3):
        raise ValueError(f"mesh {spec!r}: expected DxM or PxDxM")
    return make_mesh(parts)


def get_cfg(name: str):
    if name.startswith("tiny:"):
        return configs.get_tiny_config(name[5:])
    return configs.get_config(name)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Trainer:
    """Owns params, optimizer state, the step and the checkpoint manager.
    Weights are drawn on the device from ``seed``; the step updates them
    in place.

    With a ``mesh`` (a ``DeviceMesh``, e.g. from :func:`parse_mesh`) every
    rank draws the same weights and keeps its shards: params, moments and
    EF buffers are DTensors placed by ``param_specs(..., fsdp_only=
    cfg.fsdp_only, moe_ep=cfg.moe_ep)``; the batch is placed by
    ``batch_specs(all_axes=cfg.fsdp_only)``, the local loss scaled by
    ``1 / sharding.batch_ranks`` so that the gradients' partial sums over
    the batch ranks count every batch shard once (each "model" rank
    computes its shard's gradient once), and the logged losses are
    all-reduced once per ``log_every`` steps (every "model" rank holds its
    batch shard's whole loss)."""

    def __init__(self, cfg, ckpt_dir=None, *, mesh=None, lr=3e-4, eps=1e-8,
                 compress="none", seed=0, keep=3, device=None):
        self.cfg, self.mesh = cfg, mesh
        self.device = (_device.resolve(device) if mesh is None
                       else _mesh_device(mesh))
        self.compressor = GradCompressor(compress)
        params = MD.init_params(seed, cfg, device=self.device)
        if mesh is not None:
            self.pspecs = SH.param_specs(params, mesh,
                                         fsdp_only=cfg.fsdp_only,
                                         moe_ep=cfg.moe_ep)
            params = SH.distribute(params, self.pspecs, mesh)
        self.params = params
        self.opt = adamw.init(self.params, moment_dtype_for(cfg))
        self.world = 1 if mesh is None else mesh.size()
        self.batch_ranks = 1 if mesh is None else SH.batch_ranks(
            mesh, all_axes=cfg.fsdp_only)
        self.step_fn = self._build_step(lr, eps)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir
                     else None)
        self.step = 0

    def _build_step(self, lr, eps):
        scale = 1.0 / self.batch_ranks
        if self.compressor.method == "none":
            base = make_train_step(self.cfg, lr=lr, eps=eps,
                                   loss_scale=scale)

            def stepc(params, opt, ef, batch):
                p, o, m = base(params, opt, batch)
                return p, o, ef, m
        else:
            compressor = self.compressor

            def stepc(params, opt, ef, batch):
                # gradients of the f32 params, then the compression NT chain
                (_, m), grads = value_and_grad(params, self.cfg, batch, scale)
                grads, ef, cm = compressor.compress(grads, ef)
                params, opt, om = adamw.update(grads, opt, params, lr=lr,
                                               eps=eps)
                return params, opt, ef, {**m, **om, **cm}
        if self.mesh is None:
            return stepc

        def sharded(*args):
            with pctx.policy(self.mesh, dp_all_axes=self.cfg.fsdp_only):
                return stepc(*args)
        return sharded

    def _place(self, b: dict) -> list:
        """The host batch as this rank's shards, split into the
        ``grad_accum`` microbatches of the compress-free step
        (``data.place_microbatches``)."""
        accum = self.cfg.grad_accum if self.compressor.method == "none" \
            else 1
        micro = place_microbatches(b, accum, self.mesh,
                                   all_axes=self.cfg.fsdp_only)
        return micro if self.compressor.method == "none" else micro[0]

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
        losses, pending = [], []
        t0 = time.time()
        while self.step < steps:
            if self.mesh is None:
                b = data.batch(self.step)
            else:
                b = self._place(data.host_batch(self.step))
            self.params, self.opt, ef, m = self.step_fn(
                self.params, self.opt, ef, b)
            self.step += 1
            # keep the loss on the device: converting every step would
            # block the launch queue once per step; the whole history
            # crosses to the host once at return
            pending.append(m["loss"])
            if self.step % log_every == 0 or self.step == steps:
                losses.extend(self._reduce(pending))
                pending = []
                m = {**m, "loss": losses[-1]}
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
        losses.extend(self._reduce(pending))
        if self.ckpt:
            self.ckpt.wait()
        if not losses:
            return []
        return torch.stack(losses).cpu().tolist()   # ONE device->host copy

    def _reduce(self, local_losses: list) -> list:
        """The whole batch's losses of the steps since the last call: each
        rank's local loss summed over the mesh and divided by its size, one
        all-reduce for all of them."""
        if self.mesh is None or not local_losses:
            return local_losses
        import torch.distributed as dist
        t = torch.stack(local_losses)
        dist.all_reduce(t)
        return list((t / self.world).unbind())


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

    cfg = get_cfg(args.arch)
    mesh, say = None, print
    if args.mesh != "1x1" or "WORLD_SIZE" in os.environ:
        mesh = _torchrun_mesh(args.mesh, args.device)
        if mesh.get_rank() != 0:
            say = lambda *_: None      # noqa: E731
    tr = Trainer(cfg, args.ckpt, mesh=mesh, lr=args.lr,
                 compress=args.compress, seed=args.seed,
                 device=None if mesh is not None else args.device)
    if tr.restore_if_any():
        say(f"[train] restored from step {tr.step}")
    losses = tr.run(args.steps, args.batch, args.seq, seed=args.seed,
                    ckpt_every=args.ckpt_every, crash_at=args.crash_at,
                    log=say)
    say(f"[train] done: first loss {losses[0]:.6f} "
        f"last loss {losses[-1]:.6f}")
    return 0


def _torchrun_mesh(spec: str, device):
    """The mesh of a ``torchrun`` job: its process group from the
    environment (NCCL on the card, gloo for ``--device cpu``)."""
    import torch.distributed as dist

    cpu = device is not None and torch.device(device).type == "cpu"
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(f"--mesh {spec}: a mesh needs one process a rank; "
                           "run under torchrun")
    if not dist.is_initialized():
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl")
    n = math.prod(int(x) for x in spec.split("x"))
    if n != dist.get_world_size():
        raise ValueError(f"--mesh {spec} has {n} ranks, the job "
                         f"{dist.get_world_size()}")
    return parse_mesh(spec)


if __name__ == "__main__":
    raise SystemExit(main())
