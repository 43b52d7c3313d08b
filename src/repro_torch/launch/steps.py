"""Step functions (train / prefill / decode) + abstract input specs: the
JAX package's ``launch/steps.py`` on tensors.

The step functions update their state in place and return it.
``input_specs(arch, shape)`` returns fake-tensor stand-ins for every model
input (``FakeTensorMode``: shapes and dtypes, no memory), used by the
multi-pod dry run and the roofline harness; each cell's trees belong to its
own ``CellSpec.mode``, under which the cell is traced.  The decode step's
position is the last slot of the cache (``S - 1``, a Python int: the JAX
package's abstract int32 reads the whole cache too).
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import configs
from repro_torch._tree import leaves, map_tree, unflatten
from repro_torch.models import model as MD
from repro_torch.optim import adamw
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import (cache_specs, distribute, local,
                                            param_specs)

# Architectures whose optimizer moments are stored in bf16 so that
# params+moments fit the device memory.
BF16_MOMENT_PARAM_THRESHOLD = 20e9
SERVE_DTYPE = torch.bfloat16


def moment_dtype_for(cfg) -> str:
    n = cfg.param_counts()["total"]
    return "bfloat16" if n > BF16_MOMENT_PARAM_THRESHOLD else "float32"


def value_and_grad(params, cfg, batch, loss_scale: float = 1.0):
    """``jax.value_and_grad(MD.apply_train, has_aux=True)``: ((loss,
    metrics), grads), the metrics detached and the grads a tree of
    ``params``' structure, each of its leaf's dtype.  The grads are those of
    ``loss * loss_scale``: under a mesh, ``1 / sharding.batch_ranks``
    makes the batch ranks' partial sums the gradient of the whole batch's
    loss."""
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, metrics = MD.apply_train(unflatten(params, flat), cfg, batch)
    grads = torch.autograd.grad(loss if loss_scale == 1.0
                                else loss * loss_scale, flat)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


# ================================================================== steps ====
def make_train_step(cfg, *, lr: float = 3e-4, weight_decay: float = 0.1,
                    eps: float = 1e-8, grad_accum: int | None = None,
                    loss_scale: float = 1.0):
    """(params, opt, batch) -> (params, opt, metrics), params and opt
    updated in place.

    ``grad_accum`` > 1 loops over microbatches accumulating gradients in the
    moment dtype (the accumulator is bf16 above 20 B params).  Where the
    compute dtype is bf16, the gradients are taken with respect to a bf16
    copy of the f32 master weights, as the JAX package's mixed precision
    does.  ``loss_scale`` as in :func:`value_and_grad`; the batch may be a
    list of microbatches already split and placed on a mesh
    (``data.place_microbatches``), which sets their number.
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
        micro = batch if isinstance(batch, list) else None
        n = len(micro) if micro is not None else accum
        if n <= 1:
            (_, metrics), grads = value_and_grad(
                wp, cfg, micro[0] if micro is not None else batch, loss_scale)
        else:
            grads = map_tree(lambda x: torch.zeros_like(
                x, dtype=acc_dt, memory_format=torch.contiguous_format),
                params)
            ms = []
            for i in range(n):
                mb = micro[i] if micro is not None else {
                    k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                    for k, v in batch.items()}
                (_, m), gi = value_and_grad(wp, cfg, mb, loss_scale)
                for a, x in zip(leaves(grads), leaves(gi), strict=True):
                    local(a).add_(local(x).to(acc_dt) / n)
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        params, opt, om = adamw.update(grads, opt, params, lr=lr, eps=eps,
                                       weight_decay=weight_decay)
        return params, opt, {**metrics, **om}

    return train_step


def shard_params(params, cfg, mesh, mode: str = "prefill"):
    """``params`` as DTensors on ``mesh``, placed by the rule table for
    ``mode`` (``parallel.sharding.param_specs``)."""
    specs = param_specs(params, mesh, mode=mode, fsdp_only=cfg.fsdp_only,
                        moe_ep=cfg.moe_ep)
    return distribute(params, specs, mesh)


def shard_cache(cache, cfg, mesh, B: int):
    """A decode cache (``init_cache``'s list, whole) as DTensors on
    ``mesh``, placed by ``parallel.sharding.cache_specs`` for a global
    batch of ``B``: KV sequences over "model" (every axis when the batch
    does not divide), the scans' states over "model" by feature."""
    return distribute(cache, cache_specs(cfg, cache, mesh, B), mesh)


def make_prefill_step(cfg, mesh=None):
    """(params, batch) -> (next_token, cache).  With a ``mesh`` the params
    are :func:`shard_params`' and the step runs under its policy: on a
    "model" axis wider than 1 each rank computes its own heads, channels
    and experts (tensor parallelism, ``models.model``), or, for an
    ``fsdp_only`` config whose batch is placed with its sequence over
    "model", its own block of positions (``models.model.apply_prefill``);
    the batch is this rank's, the logits whole."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        with pctx.policy(mesh) if mesh is not None else nullcontext():
            logits, cache = MD.apply_prefill(params, cfg, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(cfg, mesh=None):
    """(params, cache, batch, pos) -> (next_token, cache).  With a ``mesh``
    the params are ``shard_params(..., mode="decode")``'s, the cache
    :func:`shard_cache`'s and the batch placed by ``batch_specs``; the
    step runs under the mesh's policy, each rank on its heads, channels,
    experts and cache positions (``models.model.apply_decode``), and
    returns its rows' next tokens."""

    @torch.inference_mode()
    def decode_step(params, cache, batch, pos):
        with pctx.policy(mesh) if mesh is not None else nullcontext():
            logits, cache = MD.apply_decode(params, cfg, cache, batch, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode_step


# ============================================================ input specs ====
def fake_mode():
    """A fresh ``FakeTensorMode`` for one cell's trees and trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def abstract_params(cfg, dtype=None, mode=None):
    """The parameter tree of ``cfg`` as fake CPU tensors (under ``mode``, a
    new one by default), floats cast to ``dtype`` when given."""
    with mode or fake_mode():
        p = MD.init_params(0, cfg, device="cpu")
        if dtype is not None:
            p = map_tree(lambda x: x.to(dtype) if x.is_floating_point()
                         else x, p)
    return p


def abstract_opt(cfg, params, mode=None):
    """AdamW's state of ``params`` (under their own fake mode by
    default)."""
    with mode or getattr(leaves(params)[0], "fake_mode", None) \
            or fake_mode():
        return adamw.init(params, moment_dtype_for(cfg))


def abstract_batch(cfg, B: int, S: int, kind: str, mode=None):
    with mode or fake_mode():
        b: dict = {}
        if cfg.frontend == "tokens":
            b["tokens"] = torch.empty((B, S), dtype=torch.int32)
        else:
            b["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=SERVE_DTYPE if kind != "train"
                                      else torch.float32)
        if kind == "train":
            b["labels"] = torch.empty((B, S), dtype=torch.int32)
    return b


def abstract_cache(cfg, B: int, max_len: int, dtype=SERVE_DTYPE, mode=None):
    with mode or fake_mode():
        return MD.init_cache(cfg, B, max_len, dtype, device="cpu")


@dataclass
class CellSpec:
    """Everything needed to trace one (arch x shape) cell."""
    cfg: Any
    shape: Any
    kind: str                      # train | prefill | decode
    step: Any                      # the python step function
    args: tuple                    # abstract arg tree (fake tensors)
    donate: tuple                  # args the step updates in place
    mode: Any = None               # the FakeTensorMode of ``args``


def input_specs(arch: str, shape_name: str) -> CellSpec:
    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    mode = fake_mode()
    if shape.kind == "train":
        params = abstract_params(cfg, mode=mode)
        opt = abstract_opt(cfg, params, mode=mode)
        batch = abstract_batch(cfg, B, S, "train", mode=mode)
        return CellSpec(cfg, shape, "train", make_train_step(cfg),
                        (params, opt, batch), donate=(0, 1), mode=mode)
    if shape.kind == "prefill":
        params = abstract_params(cfg, SERVE_DTYPE, mode=mode)
        batch = abstract_batch(cfg, B, S, "prefill", mode=mode)
        return CellSpec(cfg, shape, "prefill", make_prefill_step(cfg),
                        (params, batch), donate=(), mode=mode)
    # decode: one new token against a KV cache of length seq_len
    params = abstract_params(cfg, SERVE_DTYPE, mode=mode)
    cache = abstract_cache(cfg, B, S, mode=mode)
    batch = abstract_batch(cfg, B, 1, "decode", mode=mode)
    return CellSpec(cfg, shape, "decode", make_decode_step(cfg),
                    (params, cache, batch, S - 1), donate=(1,), mode=mode)


__all__ = ["BF16_MOMENT_PARAM_THRESHOLD", "CellSpec", "SERVE_DTYPE",
           "abstract_batch", "abstract_cache", "abstract_opt",
           "abstract_params", "fake_mode", "input_specs", "make_decode_step",
           "make_prefill_step", "make_train_step", "moment_dtype_for",
           "shard_cache", "shard_params", "value_and_grad"]
