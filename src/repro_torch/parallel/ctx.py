"""Activation-sharding context: the JAX package's ``parallel/ctx.py``, and
the collectives of the port's tensor parallelism.

The trainer, the dry run and a sharded prefill call ``set_policy(mesh)``
(or enter ``policy(mesh)``); on one device nothing sets it.  ``constrain``
/ ``constrain_acts`` redistribute a DTensor to the spec and return a plain
tensor unchanged.  The model computes on plain tensors, so it calls
neither: its layer-boundary activations stay replicated over "model" (the
JAX package's ``act_shard`` "seq" / "dmodel" calls are hints to GSPMD; see
``repro_torch.models.model``).  What the model does call:
  - ``batch_mean``: a statistic over the whole batch, all-reduced over the
    batch ranks with autograd (the MoE router's);
  - the "model" axis's group, for Megatron-style column / row pairs:
    ``tp_size`` / ``tp_rank``; ``copy_to_tp`` (identity forward, all-reduce
    backward: where a replicated activation enters a rank's shard of the
    compute); ``reduce_from_tp`` (all-reduce forward, identity backward:
    where a row-parallel product's partial sums leave it);
    ``reduce_tp`` (both: a partial product that feeds sharded compute
    again); ``max_tp`` (no gradient); ``gather_tp`` (the ranks' shards
    concatenated, no gradient: a prefill's logits and caches); and
    ``exchange`` (an all-to-all of column ranges whose backward is the
    reverse all-to-all: whole heads out of column shards, Mamba's x and z
    channel blocks paired).
The sequence group (the axes a placed sequence is split over, read from
a :class:`~repro_torch.parallel.sharding.SeqSplit`) has its own:
``seq_max`` / ``seq_sum`` (all-reduces), ``seq_gather`` (an all-gather),
``seq_last`` (the last rank's value, one broadcast), ``halo`` (the
previous rank's last positions), ``exclusive_prefix`` (the ranks before
this one folded in order) and ``seq_exchange`` (an all-to-all of equal
blocks); none carries a gradient (serving).
Under ``dp_all`` (fsdp_only) and on a 1-wide "model" axis there is no TP
group (``tp_size() == 1``) and each of these is the identity.  Sums run in
f32 and are rounded once to the input's dtype, as one GEMM's f32
accumulator rounds the whole product; an exchange moves bf16 as its
bytes.  Every collective is a ``torch.distributed`` call (a c10d op), which
gloo also runs on CUDA tensors (two ranks sharing one card in
``chip_smoke.py``); the dry run's fake group records each one.
"""
from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import P, TP, to_placements, view

_POLICY: dict | None = None


def set_policy(mesh, dp_all_axes: bool = False) -> None:
    global _POLICY
    if mesh is None:
        _POLICY = None
        return
    names = view(mesh).axis_names
    if dp_all_axes:                      # fsdp_only: batch over every axis
        dp = tuple(names)
    else:
        d_ax = tuple(a for a in names if a != TP)
        dp = d_ax if len(d_ax) > 1 else d_ax[0]
    _POLICY = {"mesh": mesh, "dp": dp, "dp_all": dp_all_axes}


@contextmanager
def policy(mesh, dp_all_axes: bool = False):
    global _POLICY
    old = _POLICY
    set_policy(mesh, dp_all_axes)
    try:
        yield
    finally:
        _POLICY = old


def active() -> bool:
    return _POLICY is not None


def dp_all() -> bool:
    """True when the batch axes cover the whole mesh (fsdp_only)."""
    return bool(_POLICY and _POLICY.get("dp_all"))


def constrain(x, *spec):
    """Redistribute a DTensor to P(*spec), where 'dp' is replaced by the
    data axes tuple; anything else comes back as it is."""
    from torch.distributed.tensor import DTensor

    if _POLICY is None or not isinstance(x, DTensor):
        return x
    spec = tuple(_POLICY["dp"] if s == "dp" else s for s in spec)
    mesh = _POLICY["mesh"]
    return x.redistribute(mesh, to_placements(P(*spec), mesh))


def constrain_acts(x, mode: str):
    """Layer-boundary activation sharding: (B, S, d).

    mode="seq"    -> P(dp, "model", None)   sequence parallelism
    mode="dmodel" -> P(dp, None, "model")   feature sharding (SSM stacks)
    mode="batch"  -> P(dp, None, None)
    """
    if _POLICY is None:
        return x
    if x.ndim != 3 or x.shape[1] == 1:          # decode: batch-only
        mode = "batch"
    if _POLICY.get("dp_all"):   # fsdp_only: "model" is a data axis already
        mode = "batch"
    if mode == "seq":
        return constrain(x, "dp", "model", None)
    if mode == "dmodel":
        return constrain(x, "dp", None, "model")
    return constrain(x, "dp", *([None] * (x.ndim - 1)))


def _dp_group():
    """The process group of the batch axes (cached in the policy)."""
    if "group" not in _POLICY:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        dp = _POLICY["dp"]
        names = dp if isinstance(dp, tuple) else (dp,)
        mesh = _POLICY["mesh"]
        if len(names) == mesh.ndim:
            _POLICY["group"] = dist.group.WORLD
        elif len(names) == 1:
            _POLICY["group"] = mesh.get_group(names[0])
        else:               # the mesh's own rank tensors, never fake ones
            with unset_fake_temporarily():
                _POLICY["group"] = mesh[names]._flatten().get_group()
    return _POLICY["group"]


def batch_mean(x):
    """The mean over the batch ranks of a statistic each rank took over its
    own batch shard: what a mean over the whole (GSPMD-sharded) batch is in
    the JAX package.  Differentiable (its backward sums the cotangents over
    the same ranks).  ``x`` itself with no policy or one batch rank."""
    if _POLICY is None or getattr(_POLICY["mesh"], "ndim", None) is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    group = _dp_group()
    n = dist.get_world_size(group)
    if n == 1:
        return x
    return all_reduce(x, group=group) / n


# ------------------------------------------- the "model" axis (TP) ----
def _tp_group():
    """The process group of the "model" axis, or None: no policy, a policy
    of ``dp_all``, a mesh without "model" or a 1-wide one."""
    if _POLICY is None or _POLICY["dp_all"]:
        return None
    if "tp_group" not in _POLICY:
        mesh = _POLICY["mesh"]
        names = view(mesh).axis_names
        group = None
        if TP in names and view(mesh).shape[TP] > 1 \
                and hasattr(mesh, "get_group"):
            group = mesh.get_group(TP)
        _POLICY["tp_group"] = group
    return _POLICY["tp_group"]


def tp_size() -> int:
    """Ranks on the "model" axis computing a shard each (1: no TP)."""
    group = _tp_group()
    return 1 if group is None else dist.get_world_size(group)


def tp_rank() -> int:
    group = _tp_group()
    return 0 if group is None else dist.get_rank(group)


def _sum(x):
    """``x`` summed over the TP ranks: an f32 all-reduce, rounded once to
    ``x``'s dtype."""
    t = x.float() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(t, group=_tp_group())
    return t.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _ReduceTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g)


class _Exchange(torch.autograd.Function):
    """The all-to-all of :func:`exchange` (``plan``: this rank's source
    columns in send order, rows sent to and received from each rank);
    backward the reverse all-to-all, each source column's gradients
    summed."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape = plan, x.shape
        idx, send, recv = plan
        rows = x.reshape(-1, x.shape[-1]).t()               # (cols, N)
        out = _all_to_all(rows.index_select(0, idx), recv, send)
        return out.t().reshape(*x.shape[:-1], out.shape[0])

    @staticmethod
    def backward(ctx, g):
        idx, send, recv = ctx.plan
        back = _all_to_all(g.reshape(-1, g.shape[-1]).t(), send, recv)
        dx = back.new_zeros((ctx.shape[-1], back.shape[1]))
        dx.index_add_(0, idx, back)
        return dx.t().reshape(ctx.shape), None


def copy_to_tp(x):
    """Identity forward; the gradient all-reduced over the TP ranks."""
    return x if tp_size() == 1 else _CopyToTP.apply(x)


def reduce_from_tp(x):
    """The TP ranks' partial sums added (f32); identity gradient."""
    return x if tp_size() == 1 else _ReduceFromTP.apply(x)


def reduce_tp(x):
    """The TP ranks' partial sums added, and so is the gradient."""
    return x if tp_size() == 1 else _ReduceTP.apply(x)


def max_tp(x):
    """The elementwise max over the TP ranks (no gradient)."""
    if tp_size() == 1:
        return x
    t = x.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_tp_group())
    return t


def _words(x):
    """``x`` (contiguous) as the words all_to_all / all_gather move bit for
    bit: a 16-bit float as bytes (gloo moves no int16), the last dim
    doubled (through the flat view: a last dim of one may carry any
    stride)."""
    if x.element_size() != 2:
        return x
    return x.reshape(-1).view(torch.uint8).view(*x.shape[:-1],
                                                 2 * x.shape[-1])


def _all_to_all(rows, out_splits, in_splits, group=None):
    """``rows`` (sum(in_splits), N) sent in blocks of ``in_splits`` rows to
    the ranks of ``group`` (default the TP ranks) in order; returns the
    (sum(out_splits), N) received."""
    rows = rows.contiguous()
    out = rows.new_empty((sum(out_splits), rows.shape[1]))
    dist.all_to_all_single(_words(out), _words(rows), list(out_splits),
                           list(in_splits), group=group or _tp_group())
    return out


def gather_tp(x, dim: int):
    """The TP ranks' ``x`` concatenated along ``dim``, in rank order (no
    gradient)."""
    n = tp_size()
    if n == 1:
        return x
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(_words(out), _words(src), group=_tp_group())
    return out.movedim(0, dim).contiguous() if dim else out


def shards(width: int, n: int) -> list:
    """The (lo, hi) columns each of ``n`` ranks holds of a ``width``-column
    dim split contiguously and evenly (a rule table's ``Shard``)."""
    w = width // n
    return [(s * w, (s + 1) * w) for s in range(n)]


@lru_cache(maxsize=256)
def exchange_plan(have: tuple, want: tuple, rank: int):
    """The all-to-all that gives each TP rank ``r`` the columns of
    ``want[r]`` (ascending, disjoint (lo, hi) ranges) from the ranks'
    columns ``have[s]`` (one (lo, hi) range a rank, disjoint): (this
    rank's source columns in send order, rows sent to each rank, rows
    received from each), or None where every rank wants exactly what it
    has."""
    n = len(have)
    if all(want[r] == (have[r],) for r in range(n)):
        return None

    def pieces(s, r):
        lo, hi = have[s]
        return [(max(a, lo), min(b, hi)) for a, b in want[r]
                if min(b, hi) > max(a, lo)]
    idx = [c - have[rank][0] for r in range(n)
           for a, b in pieces(rank, r) for c in range(a, b)]
    send = [sum(b - a for a, b in pieces(rank, r)) for r in range(n)]
    recv = [sum(b - a for a, b in pieces(s, rank)) for s in range(n)]
    return tuple(idx), send, recv


def exchange(x, have: list, want: list):
    """``x`` (..., c): the columns ``have[tp_rank()]`` of the last dim of a
    tensor each TP rank holds a range of (``have[s]`` for rank s).
    Returns (..., the columns of ``want[tp_rank()]`` in order), each rank's
    ranges as :func:`exchange_plan` takes them, in one all-to-all (a column
    wanted by several ranks is sent to each, and its gradient is their
    sum); ``x`` itself where every rank wants what it has."""
    n = tp_size()
    if n == 1:
        return x
    have = tuple(tuple(r) for r in have)
    want = tuple(tuple(tuple(r) for r in ranges) for ranges in want)
    plan = exchange_plan(have, want, tp_rank())
    if plan is None:
        return x
    idx, send, recv = plan
    idx = torch.tensor(idx, dtype=torch.long, device=x.device)
    return _Exchange.apply(x, (idx, send, recv))


# ------------------------------------------------- the sequence group ----
def seq_group(split):
    """The process group of ``split``'s axes (a :class:`~repro_torch.
    parallel.sharding.SeqSplit`): "model"'s, every axis's (the default
    group) or a flattened sub-mesh's; None for one rank.  Cached in the
    policy.  Its group ranks run in the split's index order, which is
    checked: a mismatch raises."""
    if split.n == 1:
        return None
    mesh = split.mesh
    key = ("seq_group", id(mesh), split.axes)
    cache = _POLICY if _POLICY is not None else {}
    if key not in cache:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        if len(split.axes) == mesh.ndim:
            group = dist.group.WORLD
        elif len(split.axes) == 1:
            group = mesh.get_group(split.axes[0])
        else:
            with unset_fake_temporarily():
                group = mesh[split.axes]._flatten().get_group()
        if dist.get_world_size(group) != split.n \
                or dist.get_rank(group) != split.index:
            raise RuntimeError(f"{split}: group rank {dist.get_rank(group)}"
                               f" of {dist.get_world_size(group)}")
        cache[key] = group
    return cache[key]


def seq_max(x, split):
    """The elementwise max of ``x`` over the sequence group."""
    if split.n == 1:
        return x
    t = x.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=seq_group(split))
    return t


def seq_sum(x, split):
    """``x`` summed over the sequence group: an f32 all-reduce, rounded
    once to ``x``'s dtype."""
    if split.n == 1:
        return x
    t = x.float() if x.dtype != torch.float32 else x.detach().clone()
    dist.all_reduce(t, group=seq_group(split))
    return t.to(x.dtype)


def seq_gather(x, split):
    """Every rank's ``x`` of the sequence group, stacked in index order:
    (n, *x.shape), bit for bit."""
    if split.n == 1:
        return x[None]
    src = x.detach().reshape(1, *x.shape).contiguous()
    out = src.new_empty((split.n, *x.shape))
    dist.all_gather_into_tensor(_words(out), _words(src),
                                group=seq_group(split))
    return out


def seq_last(x, split):
    """The last rank's ``x`` (the sequence's end), on every rank of the
    group: one broadcast."""
    if split.n == 1:
        return x
    t = x.detach().contiguous().clone()
    dist.broadcast(_words(t), group=seq_group(split), group_src=split.n - 1)
    return t


def halo(x, k: int, split):
    """The previous rank's last ``k`` positions of ``x`` (B, S_local, ...)
    along dim 1: (B, k, ...), zeros on the first rank (the sequence's
    start, as one process's zero padding)."""
    tail = x[:, -k:]
    if split.n == 1:
        return torch.zeros_like(tail)
    got = seq_gather(tail, split)
    return got[split.index - 1] if split.index else torch.zeros_like(tail)


def exclusive_prefix(xs: tuple, split, combine):
    """The ranks before this one folded in index order: ``acc = None``, then
    ``acc = combine(acc, rank j's xs)`` for j < index (one all-gather a
    tensor of ``xs``).  None on the first rank."""
    if split.index == 0:
        if split.n > 1:                  # every rank joins the gathers
            for x in xs:
                seq_gather(x, split)
        return None
    got = [seq_gather(x, split) for x in xs]
    acc = None
    for j in range(split.index):
        acc = combine(acc, tuple(g[j] for g in got))
    return acc


def seq_exchange(x, split):
    """``x`` (n, ...): block j sent to rank j of the sequence group, in one
    all-to-all; returns (n, ...), block j from rank j, bit for bit."""
    if split.n == 1:
        return x
    rows = x.reshape(split.n, -1)
    out = _all_to_all(rows, [1] * split.n, [1] * split.n,
                      group=seq_group(split))
    return out.reshape(x.shape)


__all__ = ["active", "batch_mean", "constrain", "constrain_acts",
           "copy_to_tp", "dp_all", "exchange", "exchange_plan",
           "exclusive_prefix", "gather_tp", "halo", "max_tp", "policy",
           "reduce_from_tp", "reduce_tp", "seq_exchange", "seq_gather",
           "seq_group", "seq_last", "seq_max", "seq_sum", "set_policy",
           "shards", "tp_rank", "tp_size"]
