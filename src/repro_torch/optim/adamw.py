"""AdamW with global-norm clipping and configurable moment dtype: the JAX
package's ``optim/adamw.py`` on tensors.

Moments may be stored in bf16 (``moment_dtype="bfloat16"``) for the largest
architectures so the optimizer state fits the card; the update math runs in
f32 either way.  The clip scale and the bias corrections are f32 device
scalars computed from the device step ``count``, as in the JAX package.

The update runs tensor by tensor and **in place**: params and moments are
overwritten and returned.  That keeps the f32 temporaries one tensor wide,
which is what the JAX package's ``layer_scan`` buys, so there is no such
switch here.  The math is written out as tensor ops, not
``torch.optim.AdamW``, whose clipping, decay and bias-correction order are
not the reference's.

Under a mesh the trees hold DTensors (``launch.train.Trainer(mesh=...)``):
the update runs on each rank's local shards, and the global norm sums each
shard's squares once (a shard held by r ranks counts 1/r on each), with one
all-reduce a step.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import leaves, map_tree
from repro_torch.parallel.sharding import all_sum, local, replicas

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def init(params: Any, moment_dtype: str = "float32") -> AdamWState:
    dt = _DTYPES[moment_dtype]
    zeros = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=dt, memory_format=torch.contiguous_format)
    device = local(leaves(params)[0]).device
    return AdamWState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a device scalar);
    over a mesh the sum over every rank's shards, each shard counted
    once."""
    def sq(x):
        s = torch.linalg.vector_norm(local(x), dtype=torch.float32).square()
        r = replicas(x)
        return s if r == 1 else s / r
    return all_sum(torch.stack([sq(x) for x in leaves(tree)]).sum(),
                   tree).sqrt()


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is f32 (updated in place), else an f32 copy."""
    return x if x.dtype == torch.float32 else x.float()


@torch.no_grad()
def update(grads: Any, state: AdamWState, params: Any, *,
           lr: float | torch.Tensor, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: float = 1.0) -> tuple[Any, AdamWState, dict]:
    """One step: (params, state, {"grad_norm"}), params and moments updated
    in place.  ``grad_norm`` is reported before clipping."""
    count = state.count + 1
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    n = count.float()
    c1 = 1.0 - torch.pow(torch.full_like(n, b1), n)
    c2 = 1.0 - torch.pow(torch.full_like(n, b2), n)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v), strict=True):
        p, g, m, v = local(p), local(g), local(m), local(v)
        g32 = g.float() * scale
        m32, v32, p32 = _f32(m), _f32(v), _f32(p)
        m32.mul_(b1).add_(g32, alpha=1 - b1)
        v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        denom = torch.div(v32, c2, out=g32).sqrt_().add_(eps)
        step = torch.div(m32, c1).div_(denom)
        step.add_(p32, alpha=weight_decay).mul_(lr)
        p32.sub_(step)
        for dst, src in ((m, m32), (v, v32), (p, p32)):
            if dst is not src:
                dst.copy_(src)
    return params, AdamWState(state.m, state.v, count), {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos
    return lr


__all__ = ["AdamWState", "cosine_schedule", "global_norm", "init", "update"]
