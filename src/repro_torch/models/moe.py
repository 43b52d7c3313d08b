"""Mixture-of-Experts layer for serving and training: the JAX package's
``models/moe.py`` as plain functions on tensors.

Top-k routing with *grouped*, capacity-bounded sort dispatch (GShard-style):
tokens are grouped by batch row, and dispatch (argsort / rank / scatter)
happens inside each group along its own token axis.  The expert FFN runs on
the (E, G * C, d) rows of all groups at once through the hand-written CUDA
grouped-matmul kernel on the card (:mod:`repro_torch.kernels.moe_gmm`) and
its plain version on the CPU: three launches per layer (gate, up, down),
``silu(h) * u`` between them in plain PyTorch.  Under autograd each takes
a ``torch.bmm`` backward (:class:`~repro_torch.kernels.moe_gmm.ops.
GroupedMatmul`), and the dispatch's scatter, the sorted top k and the
combine's gathers carry the gradient to x, the gates and the router; the
router's load-balance and z losses come back as the aux loss.

Rounding points kept from the JAX package: the router computes in f32 from
``x.float()``; the gates are cast to the compute dtype before the combine;
the combine accumulates in the compute dtype; the expert weights are taken
in ``x.dtype`` at use (the kernel rounds f32 weights to bf16 as it loads
them, the same values as a cast).  Differences that change no result:
  - ``pctx.constrain`` (sharding annotations) is dropped, and with it the
    ``moe_ep`` branch, whose math is the same: the port's sharded step
    runs each layer on gathered weights, so expert parallelism is the
    experts' placement alone (``(TP, f, None)`` / ``(TP, None, f)`` from
    ``parallel.sharding.param_specs``); the router's batch means go
    through ``pctx.batch_mean``, a no-op on one device;
  - ``torch.topk`` does not promise an order among equal values, so the
    top k come from a stable descending sort, which keeps the lower expert
    first as ``jax.lax.top_k`` does;
  - the combine gathers each token's k contributions and adds them in the
    order of the sorted dispatch (ascending expert), the order the JAX
    scatter-add visits them, so the sum is deterministic on the card
    (``index_add_`` there uses atomics in no fixed order).
The ``moe_dense_mode`` branch (every expert on every token, a smoke-test
fallback no config sets) stays plain einsum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.parallel import ctx as pctx

from .layers import linear_init, normal


def moe_init(gen, cfg, dtype=torch.float32, device=None):
    d, dff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)

    def stack(a, b, s):
        return normal(gen, (E, a, b), device).mul_(s).to(dtype)

    return {
        "router": linear_init(gen, d, E, dtype=torch.float32,   # router f32
                              device=device),
        "gate": stack(d, dff, scale),
        "up": stack(d, dff, scale),
        "down": stack(dff, d, 1.0 / math.sqrt(dff)),
    }


def router_topk(p, x, cfg):
    """x: (..., d) -> gates (..., k) f32, idx (..., k), aux_loss (scalar)."""
    logits = x.float() @ p["router"]["w"].float()               # (..., E)
    probs = torch.softmax(logits, dim=-1)
    k = cfg.moe_top_k
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balance loss + router z-loss
    E = cfg.n_experts
    # means over the whole batch: over every batch shard under a mesh
    me = pctx.batch_mean(probs.reshape(-1, E).mean(0))   # mean prob / expert
    ce = pctx.batch_mean(F.one_hot(idx.reshape(-1, k)[:, 0], E).float()
                         .mean(0))
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = cfg.moe_aux_coeff * lb + cfg.moe_z_coeff * z
    return gates, idx, aux


def capacity(tokens_per_group: int, cfg) -> int:
    c = int(math.ceil(tokens_per_group * cfg.moe_top_k
                      * cfg.moe_capacity_factor / cfg.n_experts))
    c = max(cfg.moe_top_k, c)
    return -(-c // 8) * 8 if c >= 8 else c       # multiple of 8 when large


def _group_dispatch(x, gates, idx, E: int, C: int):
    """Dispatch of every group at once.  x: (G, T, d); gates, idx: (G, T,
    k).

    Returns (x_exp (G, E, C, d), slot, keep, t_s, g_s), each of the last
    four (G, T * k) in sorted (expert-major, stable) order: everything the
    combine needs."""
    G, T, d = x.shape
    k = idx.shape[-1]
    TK = T * k
    e_flat = idx.reshape(G, TK)
    g_flat = gates.reshape(G, TK).to(x.dtype)
    t_flat = torch.arange(T, device=x.device).repeat_interleave(k)

    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_s = torch.gather(e_flat, 1, order)
    t_s = t_flat[order]
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 1) - counts                   # exclusive
    rank = torch.arange(TK, device=x.device)[None] - \
        torch.gather(starts, 1, e_s)
    keep = rank < C
    slot = torch.where(keep, e_s * C + rank, torch.full_like(rank, E * C))

    rows = torch.arange(G, device=x.device)[:, None]
    x_exp = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    x_exp[rows, slot] = x[rows, t_s]                  # row E*C takes drops
    return (x_exp[:, :-1].reshape(G, E, C, d), slot, keep, t_s,
            torch.gather(g_flat, 1, order))


def _group_combine(y_exp, slot, keep, t_s, g_s, T: int):
    """y_exp: (G, E, C, d) -> y (G, T, d) weighted by the router gates.
    Each token's k contributions are added in sorted order, from zero, in
    y_exp's dtype."""
    G, E, C, d = y_exp.shape
    rows = torch.arange(G, device=y_exp.device)[:, None]
    contrib = y_exp.reshape(G, E * C, d)[rows, slot.clamp(max=E * C - 1)] \
        * (g_s * keep)[..., None]                            # (G, TK, d)
    k = slot.shape[1] // T
    # where each token's k entries sit in the sorted order, ascending
    pos = torch.argsort(t_s, dim=-1, stable=True).reshape(G, T, k)
    y = torch.zeros((G, T, d), dtype=y_exp.dtype, device=y_exp.device)
    for j in range(k):
        y = y + contrib[rows, pos[..., j]]
    return y


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (y, aux_loss).  Grouped capacity dispatch (group =
    batch row)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k

    gates, idx, aux = router_topk(p, x, cfg)          # (B, S, k)

    if cfg.moe_dense_mode:
        # tiny-config fallback: run every expert on every token (smoke tests)
        xf = x.reshape(B * S, d)
        h = torch.einsum("td,edf->tef", xf, p["gate"].to(xf.dtype))
        u = torch.einsum("td,edf->tef", xf, p["up"].to(xf.dtype))
        y_all = torch.einsum("tef,efd->ted", F.silu(h) * u,
                             p["down"].to(xf.dtype))          # (T, E, d)
        full_w = torch.zeros((B * S, E), dtype=xf.dtype, device=x.device)
        full_w.scatter_add_(1, idx.reshape(B * S, k),
                            gates.reshape(B * S, k).to(xf.dtype))
        y = torch.einsum("ted,te->td", y_all, full_w)
        return y.reshape(B, S, d), aux

    C = capacity(S, cfg)
    x_exp, slot, keep, t_s, g_s = _group_dispatch(x, gates, idx, E, C)
    # (G, E, C, d) -> (E, G * C, d): one grouped matmul per projection
    xe = x_exp.transpose(0, 1).reshape(E, B * C, d)
    h = grouped_matmul(xe, p["gate"])
    u = grouped_matmul(xe, p["up"])
    ye = grouped_matmul(F.silu(h) * u, p["down"])             # (E, G*C, d)
    y_exp = ye.reshape(E, B, C, d).transpose(0, 1)
    y = _group_combine(y_exp, slot, keep, t_s, g_s, S)
    return y, aux


__all__ = ["capacity", "moe_apply", "moe_init", "router_topk"]
