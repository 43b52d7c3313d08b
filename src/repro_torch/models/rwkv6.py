"""RWKV-6 ("Finch") blocks for serving: the JAX package's
``models/rwkv6.py`` on tensors.

Attention-free token mixing with a data-dependent per-channel decay, and
the squared-ReLU channel mix (arXiv:2404.05892):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), per token)
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with token-shift dd-lerp mixing (one shared LoRA rank for the five mixes w,
k, v, r, g), a per-head group norm, and a (hd, hd) f32 state per head that
is all a layer carries from one token to the next, beside the last token
of each block's input.

The recurrence goes through the hand-written CUDA kernel on the card
(:mod:`repro_torch.kernels.rwkv6_scan`) and its plain version on the CPU:
once a layer in prefill and in every decode step (a scan of one step from
the carried state, written back in place); in training, where autograd
records it, once a ``cfg.rwkv_chunk``-step segment, as the JAX package's
checkpointed ``wkv_scan`` cuts it (:func:`~repro_torch.kernels.rwkv6_scan.
segmented_wkv`).  Rounding points kept from the JAX package:
the dd-lerp and both LoRAs in the compute dtype; the decay LoRA cast to f32
before ``exp(-exp(.))``; r, k and v cast to f32 after their linear; the
group norm in f32, cast back to the compute dtype; g = silu in the compute
dtype.

Tensor parallelism (``tp=True``, the decode rule table: ``wr`` / ``wk`` /
``wv`` / ``wg`` and the channel mix's ``wk`` / ``wr`` column-parallel,
``wo`` and the channel mix's ``wv`` row-parallel, the state's heads over
"model" where they divide) and the sequence split of an ``fsdp_only``
prefill (``split``: token shifts from the rank before, the WKV state
carried across the ranks in two passes) are in :func:`_timemix_tp`,
:func:`_split_scan` and :func:`channelmix_apply`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import segmented_wkv, wkv
from repro_torch.parallel import ctx as pctx

from .layers import linear, linear_init, normal


def _ortho(gen, shape, scale, dtype, device):
    return normal(gen, shape, device).mul_(scale).to(dtype)


def timemix_init(gen, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_size
    if H * hd != d:
        raise ValueError(f"rwkv heads {H} x head size {hd} != d_model {d}")
    r = cfg.rwkv_lora_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "mu_x": torch.zeros((d,), **kw),             # base shift mix
        "mu": torch.zeros((5, d), **kw),             # per-channel (w,k,v,r,g)
        "lora_a": _ortho(gen, (d, 5 * r), 0.01, dtype, device),
        "lora_b": _ortho(gen, (5, r, d), 0.01, dtype, device),
        "w0": torch.full((d,), -6.0, **kw),          # decay bias (slow decay)
        "wa": _ortho(gen, (d, 2 * r), 0.01, dtype, device),
        "wb": _ortho(gen, (2 * r, d), 0.01, dtype, device),
        "u": _ortho(gen, (d,), 0.1, dtype, device),  # bonus
        "wr": linear_init(gen, d, d, **kw),
        "wk": linear_init(gen, d, d, **kw),
        "wv": linear_init(gen, d, d, **kw),
        "wg": linear_init(gen, d, d, **kw),
        "wo": linear_init(gen, d, d, **kw),
        "ln_g": torch.ones((d,), **kw),              # per-head group norm
        "ln_b": torch.zeros((d,), **kw),
    }


def _shifted(x, x_prev_last):
    """The token before each of x's: ``x_prev_last`` (B, d), zero when
    None, then x without its last token, all in x's dtype.  (The JAX
    package promotes instead where the two dtypes differ, which only its
    engine's prelaunch, decoding from an f32 cache, does; nothing reads
    that run's output.)"""
    first = torch.zeros_like(x[:, :1]) if x_prev_last is None else \
        x_prev_last[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift mixing -> the 5 mixed inputs (w,k,v,r,g),
    stacked as (5, B, S, d)."""
    xx = x_prev - x                                           # (B, S, d)
    xbase = x + xx * p["mu_x"].to(x.dtype)
    B, S, d = x.shape
    r = p["lora_b"].shape[1]
    lo = torch.tanh(xbase @ p["lora_a"].to(x.dtype)).reshape(B, S, 5, r)
    delta = torch.einsum("bsnr,nrd->nbsd", lo, p["lora_b"].to(x.dtype))
    mix = p["mu"].to(x.dtype)[:, None, None, :] + delta      # (5, B, S, d)
    return x[None] + xx[None] * mix


def _decay_rate(p, xw):
    """exp(w0 + lora(xw)), f32 (B, S, d): the per-channel decay w_t in
    (0, 1) is exp(-rate)."""
    lo = torch.tanh(xw @ p["wa"].to(xw.dtype)) @ p["wb"].to(xw.dtype)
    return torch.exp(p["w0"].float() + lo.float())


def _groupnorm_heads(p, y, H, hd, eps=64e-5, cols=None):
    """Layer norm of each head's hd values, in f32; returns f32.  ``cols``:
    the (lo, hi) channels of the gains that ``y``'s heads are (all of them
    by default)."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, hd).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    lo, hi = cols or (0, d)
    return yh.reshape(B, S, d) * p["ln_g"][lo:hi].float() \
        + p["ln_b"][lo:hi].float()


def timemix_inputs(p, x, cfg, x_prev_last=None, rate: bool = False):
    """The scan's inputs from x (B, S, d): r, k, v, w (B, S, H, hd) f32,
    u (H, hd) f32, and the gate g (B, S, d) in x's dtype; with ``rate``
    also the decay's rate exp(.) (B, S, H, hd), w = exp(-rate)."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_size
    mw, mk, mv, mr, mg = _ddlerp(p, x, _shifted(x, x_prev_last))
    ew = _decay_rate(p, mw).reshape(B, S, H, hd)
    w = torch.exp(-ew)
    r, k, v = (linear(p[name], m).reshape(B, S, H, hd).float().contiguous()
               for name, m in (("wr", mr), ("wk", mk), ("wv", mv)))
    g = F.silu(linear(p["wg"], mg))
    u = p["u"].float().reshape(H, hd).contiguous()
    if rate:
        return r, k, v, w.contiguous(), u, g, ew
    return r, k, v, w.contiguous(), u, g


def timemix_out(p, x, cfg, y, g):
    """The block's output from the scan's y (B, S, H, hd) f32."""
    B, S, d = x.shape
    y = _groupnorm_heads(p, y.reshape(B, S, d), cfg.rwkv_heads,
                         cfg.rwkv_head_size).to(x.dtype)
    return linear(p["wo"], y * g)


def _split_scan(r, k, v, w, u, ew, split):
    """The WKV scan of this rank's block of a sequence split over ranks,
    from the sequence's zero start: each rank but the last scans its block
    from zero (its end state and its keys' total decay exp(-sum rate) go
    to the ranks after it), an exclusive prefix over the ranks folds them
    into this rank's start state (S <- diag(prod w) S + S_block, in
    order), and each rank but the first scans its block again from there
    (the first rank's zero-start scan is already the sequence's).
    Returns (y, this block's end state)."""
    y = None
    if not split.last:
        y, st = wkv(r, k, v, w, u)
        decay = torch.exp(-ew.sum(1))                        # (B, H, hd)
    else:
        st = r.new_zeros((r.shape[0], r.shape[2], r.shape[3], r.shape[3]))
        decay = torch.ones_like(st[..., 0])

    def fold(acc, item):
        d, s = item
        return s if acc is None else d[..., None] * acc + s
    start = pctx.exclusive_prefix((decay, st), split, fold)
    if split.index > 0:
        y, st = wkv(r, k, v, w, u, start.contiguous(), start)
    return y, st


def _timemix_tp(p, x, cfg, x_prev_last, state):
    """The time mix on this rank's columns of ``wr`` / ``wk`` / ``wv`` /
    ``wg`` and rows of ``wo`` (the decode rule table).  Where ``state``
    holds ``H / tp`` heads they are the rank's columns, and only the
    output's partial sums move (one all-reduce).  Where it holds every
    head (the rule table leaves the state whole when the heads do not
    divide over "model"; the columns then cut a head), the four
    projections' columns are gathered (decode: B x 4 d values), every
    rank scans every head, and its own columns of the gated output enter
    its rows of ``wo``."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_size
    n, rank = pctx.tp_size(), pctx.tp_rank()
    mw, mk, mv, mr, mg = _ddlerp(p, x, _shifted(x, x_prev_last))
    cols = [linear(p[name], m) for name, m in
            (("wr", mr), ("wk", mk), ("wv", mv), ("wg", mg))]
    c = cols[0].shape[-1]
    h = state.shape[1]
    if c * n != d or not (h == H or h * n == H):
        raise ValueError(f"RWKV columns {c} and a state of {h} heads a "
                         f"rank on {n} ranks of {d} columns, {H} heads")
    whole = h == H
    if whole:                                   # gather, scan every head
        got = pctx.gather_tp(torch.stack(cols)[None], 0)  # (n, 4, B, S, c)
        cols = list(got.permute(1, 2, 3, 0, 4).reshape(4, B, S, d))
    a = 0 if whole else rank * c                # the scanned channels
    r, k, v = (t.reshape(B, S, h, hd).float().contiguous() for t in cols[:3])
    g = F.silu(cols[3])
    ew = _decay_rate(p, mw)[..., a:a + h * hd]
    w = torch.exp(-ew).reshape(B, S, h, hd).contiguous()
    u = p["u"][a:a + h * hd].float().reshape(h, hd).contiguous()
    y, state = wkv(r, k, v, w, u, state, state)
    y = _groupnorm_heads(p, y.reshape(B, S, h * hd), h, hd,
                         cols=(a, a + h * hd)).to(x.dtype) * g
    if whole:
        y = y[..., rank * c:(rank + 1) * c]
    return pctx.reduce_from_tp(linear(p["wo"], y)), state


def timemix_apply(p, x, cfg, x_prev_last=None, state=None, tp: bool = False,
                  split=None):
    """x: (B, S, d); x_prev_last: (B, d) last token of the previous segment
    (decode); state: (B, H, hd, hd) f32.  Returns (out, (x_last, state)).

    A given ``state`` is updated **in place** to the final state and
    returned (the JAX package returns a new array); without one the scan
    starts from zero and the final state is a new tensor.  Where autograd
    records an input, the scan runs in ``cfg.rwkv_chunk``-step segments and
    is differentiable.  With ``tp`` the weights are this rank's shards and
    ``state`` holds its heads (:func:`_timemix_tp`).  With a sequence
    ``split`` of more than one rank, x is this rank's block of a sequence
    that starts from zero: the token shift takes its first previous token
    from the rank before (``ctx.halo``), the scan carries the state across
    the ranks in two passes (:func:`_split_scan`), and ``state`` receives
    this block's end state; ``x_last`` is the block's."""
    if tp:
        out, state = _timemix_tp(p, x, cfg, x_prev_last, state)
        return out, (x[:, -1, :], state)
    if split is not None and split.n > 1:
        if x_prev_last is not None:
            raise ValueError("a sequence-split time mix starts from zero")
        r, k, v, w, u, g, ew = timemix_inputs(p, x, cfg,
                                              pctx.halo(x, 1, split)[:, 0],
                                              rate=True)
        y, st = _split_scan(r, k, v, w, u, ew, split)
        state = st if state is None else state.copy_(st)
        return timemix_out(p, x, cfg, y, g), (x[:, -1, :], state)
    r, k, v, w, u, g = timemix_inputs(p, x, cfg, x_prev_last)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        y, st = segmented_wkv(r, k, v, w, u, state, cfg.rwkv_chunk)
        state = st if state is None else state.copy_(st)
    else:
        y, state = wkv(r, k, v, w, u, state, state)
    return timemix_out(p, x, cfg, y, g), (x[:, -1, :], state)


def channelmix_init(gen, cfg, dtype=torch.float32, device=None):
    d, dff = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "mu_k": torch.zeros((d,), **kw),
        "mu_r": torch.zeros((d,), **kw),
        "wk": linear_init(gen, d, dff, **kw),
        "wv": linear_init(gen, dff, d, **kw),
        "wr": linear_init(gen, d, d, **kw),
    }


def channelmix_apply(p, x, cfg, x_prev_last=None, tp: bool = False,
                     split=None):
    """x: (B, S, d); x_prev_last: (B, d) or None.  Returns (out, x_last).
    With ``tp`` ``wk`` and ``wr`` are this rank's columns and ``wv`` its
    rows: the row-parallel sum is added over the ranks and the receptance
    gathered whole before it gates that sum.  With a sequence ``split`` of
    more than one rank the first previous token is the rank before's last
    (zero on the first rank)."""
    if split is not None and split.n > 1:
        if x_prev_last is not None:
            raise ValueError("a sequence-split channel mix starts from zero")
        x_prev_last = pctx.halo(x, 1, split)[:, 0]
    xx = _shifted(x, x_prev_last) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(linear(p["wk"], xk)))
    r = torch.sigmoid(linear(p["wr"], xr))
    kv = linear(p["wv"], k)
    if tp:
        kv = pctx.reduce_from_tp(kv)
        r = pctx.gather_tp(r, -1)
    return r * kv, x[:, -1, :]


__all__ = ["channelmix_apply", "channelmix_init", "timemix_apply",
           "timemix_init", "timemix_inputs", "timemix_out"]
