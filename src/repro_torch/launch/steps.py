"""Step functions (train / prefill / decode): the JAX package's
``launch/steps.py`` on tensors.

The step functions update their state in place and return it.  The JAX
package's ``abstract_*``, ``input_specs`` and ``CellSpec`` trace every
(arch x shape) cell for its multi-pod dry run and belong with the mesh-only
modules (ROADMAP Queue 1 #7).
"""
from __future__ import annotations

import torch

from repro_torch._tree import leaves, map_tree, unflatten
from repro_torch.models import model as MD
from repro_torch.optim import adamw

# Architectures whose optimizer moments are stored in bf16 so that
# params+moments fit the device memory.
BF16_MOMENT_PARAM_THRESHOLD = 20e9
SERVE_DTYPE = torch.bfloat16


def moment_dtype_for(cfg) -> str:
    n = cfg.param_counts()["total"]
    return "bfloat16" if n > BF16_MOMENT_PARAM_THRESHOLD else "float32"


def value_and_grad(params, cfg, batch):
    """``jax.value_and_grad(MD.apply_train, has_aux=True)``: ((loss,
    metrics), grads), the metrics detached and the grads a tree of
    ``params``' structure, each of its leaf's dtype."""
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, metrics = MD.apply_train(unflatten(params, flat), cfg, batch)
    grads = torch.autograd.grad(loss, flat)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


# ================================================================== steps ====
def make_train_step(cfg, *, lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_accum: int | None = None):
    """(params, opt, batch) -> (params, opt, metrics), params and opt
    updated in place.

    ``grad_accum`` > 1 loops over microbatches accumulating gradients in the
    moment dtype (the accumulator is bf16 above 20 B params).  Where the
    compute dtype is bf16, the gradients are taken with respect to a bf16
    copy of the f32 master weights, as the JAX package's mixed precision
    does.
    """
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    acc_dt = getattr(torch, moment_dtype_for(cfg))
    mixed = cfg.compute_dtype == "bfloat16"

    def cast_params(t):
        if not mixed:
            return t
        return map_tree(lambda x: x.to(torch.bfloat16)
                        if x.is_floating_point() else x, t)

    def train_step(params, opt, batch):
        wp = cast_params(params)
        if accum <= 1:
            (_, metrics), grads = value_and_grad(wp, cfg, batch)
        else:
            grads = map_tree(lambda x: torch.zeros(x.shape, dtype=acc_dt,
                                                   device=x.device), params)
            ms = []
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                (_, m), gi = value_and_grad(wp, cfg, mb)
                for a, x in zip(leaves(grads), leaves(gi), strict=True):
                    a.add_(x.to(acc_dt) / accum)
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        params, opt, om = adamw.update(grads, opt, params, lr=lr,
                                       weight_decay=weight_decay)
        return params, opt, {**metrics, **om}

    return train_step


def make_prefill_step(cfg):
    """(params, batch) -> (next_token, cache)."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, cache = MD.apply_prefill(params, cfg, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(cfg):
    """(params, cache, batch, pos) -> (next_token, cache)."""

    @torch.inference_mode()
    def decode_step(params, cache, batch, pos):
        logits, cache = MD.apply_decode(params, cfg, cache, batch, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode_step


__all__ = ["BF16_MOMENT_PARAM_THRESHOLD", "SERVE_DTYPE", "make_decode_step",
           "make_prefill_step", "make_train_step", "moment_dtype_for",
           "value_and_grad"]
