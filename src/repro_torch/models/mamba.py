"""Mamba (S6 selective-state-space) block for serving, as Jamba's Mamba
layers use it: the JAX package's ``models/mamba.py`` on tensors.

    x, z   = in_proj(u)                       # (B, S, d_inner) each
    x      = silu(causal_depthwise_conv(x))
    dt,B,C = x_proj(x)                        # dt: (dt_rank,), B/C: (d_state,)
    dt     = softplus(dt_proj(dt) + dt_bias)
    h_t    = exp(dt*A) * h_{t-1} + (dt*B_t) * x_t
    y_t    = <h_t, C_t> + D * x_t
    out    = out_proj(y * silu(z))

The scan goes through the hand-written CUDA kernel on the card
(:mod:`repro_torch.kernels.mamba_scan`) and its plain version on the CPU:
once a layer in prefill and in every decode step (a scan of one step from
the carried state); in training, where autograd records it, once a
``cfg.mamba_chunk``-step segment, as the JAX package's checkpointed
``lax.scan`` cuts it (:func:`~repro_torch.kernels.mamba_scan.
segmented_scan`).  Rounding points kept from the JAX package:
``in_proj``, the conv and ``silu`` in the compute dtype; B and C cast to
f32; ``softplus(dt_proj(dt) + dt_bias)`` in f32; the scan in f32 on
``x.float()``; ``y.to(u.dtype) * silu(z)`` before ``out_proj``.
``F.softplus`` returns
its input above 20 where ``jax.nn.softplus`` adds log1p(exp(-x)) < e^-20,
which is below half an f32 step of any input above 20: the same numbers
(and the same gradient, sigmoid(x), which rounds to 1 in f32 there).

Tensor parallelism (``tp=True``: the weights are this rank's shards over
"model"): the channels ``d_inner`` are split over the ranks, rank r's
block ``c_r = [r di / tp, (r + 1) di / tp)``, and with them ``conv_w``,
``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``, the rows of the
row-parallel ``x_proj`` and ``out_proj``, and the scan's state.  The fused
``in_proj`` (d, 2 di) is split by the rule table's contiguous columns, so
rank r holds x's or z's columns of two other blocks (at tp 2 rank 0 holds
all of x, rank 1 all of z).  One all-to-all of the weight's columns pairs
them: rank r gets x's and z's columns of c_r (``pctx.exchange``; its
gradient goes back the same way).  The weight is exchanged, not the
activations GSPMD would reshard, because its (d, 2 di / tp) columns are
fewer bytes than a step's (tokens, 2 di / tp) activations at every train
and prefill shape (d = 4,096 against thousands of tokens a microbatch)
and their number does not grow with the batch.  ``x_proj``'s small
(B, S, dt_rank + 2 d_state) partial product is all-reduced, and so is its
gradient (it feeds each rank's channels again); ``out_proj``'s partial
sums are added over the ranks.  A given SSM state is the rank's channels;
a decode step runs this form at S = 1 on the cache's shards of the conv
and SSM states (``cache_specs`` splits their channels over "model").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import segmented_scan, selective_scan
from repro_torch.parallel import ctx as pctx

from .layers import linear, linear_init, normal


def mamba_init(gen, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dtr = cfg.dt_rank
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real initialisation for A
    A = torch.arange(1, ds + 1, **f32)[None, :].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=gen.device,
                   dtype=torch.float32).to(device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    inv_softplus = dt_init + torch.log(-torch.expm1(-dt_init))
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": linear_init(gen, d, 2 * di, **kw),
        "conv_w": normal(gen, (dc, di), device).mul_(
            1.0 / math.sqrt(dc)).to(dtype),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": linear_init(gen, di, dtr + 2 * ds, **kw),
        "dt_proj": linear_init(gen, dtr, di, **kw),
        "dt_bias": inv_softplus,
        "A_log": torch.log(A),                      # keep f32
        "D": torch.ones((di,), **f32),
        "out_proj": linear_init(gen, di, d, **kw),
    }


def _causal_conv(p, x, conv_state=None):
    """Depthwise causal conv over seq. x: (B, S, di). conv_state: (B, dc-1,
    di) carry-in from the previous segment (decode). Returns (y, new_state);
    the new state is a new tensor."""
    dc = p["conv_w"].shape[0]
    B, S, di = x.shape
    if conv_state is None:
        conv_state = torch.zeros((B, dc - 1, di), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                  # (B, S+dc-1, di)
    y = torch.zeros_like(x)
    for i in range(dc):  # dc is tiny (4): unrolled shift-sum
        y = y + xp[:, i:i + S, :] * p["conv_w"][i].to(x.dtype)
    y = y + p["conv_b"].to(x.dtype)
    return y, xp[:, -(dc - 1):, :].contiguous()


def ssm_scan(x, dt, Bmat, Cmat, A, D, h0=None, h_out=None,
             chunk: int = 64):
    """Selective scan. x, dt: (B, S, di); Bmat, Cmat: (B, S, ds); A: (di,
    ds); D: (di,); h0: (B, di, ds) or None (zeros).  Returns (y (B, S, di),
    h_final), f32; with ``h_out`` given the final state is written there
    (it may be ``h0``).  Where autograd records an input, the scan runs in
    ``chunk``-step segments and is differentiable; otherwise it is one
    scan."""
    args = [t.contiguous() for t in (x, dt, Bmat, Cmat, A, D)]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*args, h0)):
        y, h = segmented_scan(*args, h0, chunk)
        return y, (h if h_out is None else h_out.copy_(h))
    return selective_scan(*args, h0, h_out)


def _paired_in_proj(w):
    """This rank's columns of the fused ``in_proj`` (d, 2 di / tp) ->
    x's and z's columns of its channel block, from one exchange."""
    n = pctx.tp_size()
    cols = w.shape[1] * n
    di = cols // 2
    want = [[(lo, hi), (di + lo, di + hi)] for lo, hi in pctx.shards(di, n)]
    return pctx.exchange(w, pctx.shards(cols, n), want)


def mamba_apply(p, u, cfg, conv_state=None, ssm_state=None,
                tp: bool = False):
    """u: (B, S, d). Returns (out, (conv_state, ssm_state)).

    A given ``ssm_state`` is updated **in place** to the final state and
    returned (the JAX package returns a new array); the conv state returned
    is a new tensor either way.  With ``tp`` the states hold this rank's
    channels."""
    B, S, d = u.shape
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    if tp:
        u = pctx.copy_to_tp(u)
        xz = u @ _paired_in_proj(p["in_proj"]["w"]).to(u.dtype)
    else:
        xz = linear(p["in_proj"], u)
    x, z = torch.chunk(xz, 2, dim=-1)
    x, conv_state = _causal_conv(p, x, conv_state)
    x = F.silu(x)

    dbl = linear(p["x_proj"], x)                            # (B,S,dtr+2ds)
    if tp:
        dbl = pctx.reduce_tp(dbl)
    dt_raw = dbl[..., :dtr]
    Bmat = dbl[..., dtr:dtr + ds].float()
    Cmat = dbl[..., dtr + ds:].float()
    dt = F.softplus(linear(p["dt_proj"], dt_raw).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())                      # (di, ds)

    y, ssm_state = ssm_scan(x.float(), dt, Bmat, Cmat, A, p["D"].float(),
                            ssm_state, ssm_state, cfg.mamba_chunk)
    out = linear(p["out_proj"], y.to(u.dtype) * F.silu(z))
    return (pctx.reduce_from_tp(out) if tp else out), (conv_state, ssm_state)


__all__ = ["mamba_apply", "mamba_init", "ssm_scan"]
