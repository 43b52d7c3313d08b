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
  - ``pctx.constrain`` (sharding annotations) is dropped; the router's
    batch means go through ``pctx.batch_mean``, a no-op on one device;
  - ``torch.topk`` does not promise an order among equal values, so the
    top k come from a stable descending sort, which keeps the lower expert
    first as ``jax.lax.top_k`` does;
  - the combine gathers each token's k contributions and adds them in the
    order of the sorted dispatch (ascending expert), the order the JAX
    scatter-add visits them, so the sum is deterministic on the card
    (``index_add_`` there uses atomics in no fixed order).
The ``moe_dense_mode`` branch (every expert on every token, a smoke-test
fallback no config sets) stays plain einsum.

Tensor parallelism (``tp=True``: the expert stacks are this rank's shards
over "model"): the router and the dispatch run on every rank (the
activations are replicated over "model"; both are cheap).  Without expert
parallelism (grok-1) ``gate`` / ``up`` hold the rank's ``d_ff / tp``
columns of every expert and ``down`` its rows: the grouped matmuls run on
them and each rank's combine is a partial sum.  With ``moe_ep`` (Jamba)
the stacks hold the rank's ``E / tp`` whole experts: the grouped matmuls
run on their slice of the dispatched rows and the combine takes only
their slots.  Either way the ranks' combines are added (one all-reduce),
and the dispatched rows and the gates enter the rank's share through
``pctx.copy_to_tp`` so that their gradients are whole; no all-to-all is
needed while activations are replicated over "model".  A decode step
runs the same form at S = 1.

A sequence split over ranks (an ``fsdp_only`` prefill, replicated
weights) keeps the whole row's capacity and dispatch order: each rank
counts the entries of the ranks before it and its experts run on its
block of every expert's slots (:func:`_split_experts`).
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


def _group_dispatch(x, gates, idx, E: int, C: int, before=None,
                    stride: int | None = None):
    """Dispatch of every group at once.  x: (G, T, d); gates, idx: (G, T,
    k).

    Returns (x_exp (G, E, C, d), slot, keep, t_s, g_s), each of the last
    four (G, T * k) in sorted (expert-major, stable) order: everything the
    combine needs.  A block of a longer group (a sequence split over
    ranks) passes ``before`` (G, E), each expert's entries in the blocks
    before it: an entry's rank in its expert counts them, so the block
    keeps exactly what the whole group keeps; ``stride`` (>= C) is then
    the slots an expert takes in x_exp and ``slot``."""
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
    if before is not None:
        starts = starts - before
    rank = torch.arange(TK, device=x.device)[None] - \
        torch.gather(starts, 1, e_s)
    keep = rank < C
    Cs = stride or C
    slot = torch.where(keep, e_s * Cs + rank, torch.full_like(rank, E * Cs))

    rows = torch.arange(G, device=x.device)[:, None]
    x_exp = torch.zeros((G, E * Cs + 1, d), dtype=x.dtype, device=x.device)
    x_exp[rows, slot] = x[rows, t_s]                  # the last row: drops
    return (x_exp[:, :-1].reshape(G, E, Cs, d), slot, keep, t_s,
            torch.gather(g_flat, 1, order))


def _group_combine(y_exp, slot, keep, t_s, g_s, T: int, e0: int = 0):
    """y_exp: (G, E, C, d) -> y (G, T, d) weighted by the router gates.
    Each token's k contributions are added in sorted order, from zero, in
    y_exp's dtype.  ``y_exp`` may hold the experts [e0, e0 + E) alone
    (expert parallelism): the slots of other experts add exact zeros."""
    G, E, C, d = y_exp.shape
    rows = torch.arange(G, device=y_exp.device)[:, None]
    local = slot - e0 * C
    keep = keep & (local >= 0) & (local < E * C)
    contrib = y_exp.reshape(G, E * C, d)[rows, local.clamp(0, E * C - 1)] \
        * (g_s * keep)[..., None]                            # (G, TK, d)
    k = slot.shape[1] // T
    # where each token's k entries sit in the sorted order, ascending
    pos = torch.argsort(t_s, dim=-1, stable=True).reshape(G, T, k)
    y = torch.zeros((G, T, d), dtype=y_exp.dtype, device=y_exp.device)
    for j in range(k):
        y = y + contrib[rows, pos[..., j]]
    return y


def _split_experts(p, x, gates, idx, cfg, split):
    """The experts of this rank's block of each batch row's tokens, a
    sequence split over ranks (replicated weights).  Capacity is the whole
    row's, C = capacity(S): one all-gather of each rank's per-expert
    counts gives every rank the entries before its block, so it keeps and
    drops exactly what the whole row does (:func:`_group_dispatch`).  Each
    expert's C slots (padded to Cp, a multiple of the ranks) are split
    into n blocks of Cp / n: every rank scatters its tokens into their
    global slots, one all-to-all sends block j of every expert to rank j
    (each slot has one owner, so the received blocks add exactly), the
    grouped matmuls run on the rank's block, one all-gather returns the
    blocks, and each rank combines its own tokens."""
    B, T, d = x.shape
    E, n = cfg.n_experts, split.n
    C = capacity(split.length, cfg)
    Cp = -(-C // n) * n
    e_flat = idx.reshape(B, -1)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    before = pctx.exclusive_prefix(
        (counts,), split, lambda acc, c: c[0] if acc is None else acc + c[0])
    x_exp, slot, keep, t_s, g_s = _group_dispatch(
        x, gates, idx, E, C, torch.zeros_like(counts) if before is None
        else before, Cp)
    blocks = x_exp.reshape(B, E, n, Cp // n, d).permute(2, 1, 0, 3, 4)
    mine = pctx.seq_exchange(blocks.contiguous(), split).sum(0)
    xe = mine.reshape(E, B * (Cp // n), d)           # (E, B * Cp / n, d)
    h = grouped_matmul(xe, p["gate"])
    u = grouped_matmul(xe, p["up"])
    ye = grouped_matmul(F.silu(h) * u, p["down"])
    got = pctx.seq_gather(ye.reshape(E, B, Cp // n, d), split)
    y_exp = got.permute(2, 1, 0, 3, 4).reshape(B, E, Cp, d)
    return _group_combine(y_exp, slot, keep, t_s, g_s, T)


def moe_apply(p, x, cfg, tp: bool = False, split=None):
    """x: (B, S, d) -> (y, aux_loss).  Grouped capacity dispatch (group =
    batch row); with ``tp`` the expert stacks are this rank's shards; with
    a sequence ``split`` of more than one rank x is this rank's block of
    each row (:func:`_split_experts`)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k

    gates, idx, aux = router_topk(p, x, cfg)          # (B, S, k)

    if cfg.moe_dense_mode:
        if tp:
            raise ValueError("moe_dense_mode has no tensor-parallel form")
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

    if split is not None and split.n > 1:
        if tp:
            raise ValueError("a sequence-split MoE has no tensor-parallel "
                             "form (its weights are replicated)")
        return _split_experts(p, x, gates, idx, cfg, split), aux
    C = capacity(S, cfg)
    x_exp, slot, keep, t_s, g_s = _group_dispatch(x, gates, idx, E, C)
    # (G, E, C, d) -> (E, G * C, d): one grouped matmul per projection
    xe = x_exp.transpose(0, 1).reshape(E, B * C, d)
    e0 = 0
    if tp:
        xe, g_s = pctx.copy_to_tp(xe), pctx.copy_to_tp(g_s)
        El = p["gate"].shape[0]
        if El != E:                 # expert parallel: this rank's experts
            e0 = pctx.tp_rank() * El
            xe = xe[e0:e0 + El]
    h = grouped_matmul(xe, p["gate"])
    u = grouped_matmul(xe, p["up"])
    ye = grouped_matmul(F.silu(h) * u, p["down"])             # (E, G*C, d)
    y_exp = ye.reshape(-1, B, C, d).transpose(0, 1)
    y = _group_combine(y_exp, slot, keep, t_s, g_s, S, e0)
    return (pctx.reduce_from_tp(y) if tp else y), aux


__all__ = ["capacity", "moe_apply", "moe_init", "router_topk"]
