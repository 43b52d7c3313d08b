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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import segmented_wkv, wkv

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


def _decay(p, xw):
    """Per-channel decay w_t in (0,1): exp(-exp(w0 + lora(xw))), f32."""
    lo = torch.tanh(xw @ p["wa"].to(xw.dtype)) @ p["wb"].to(xw.dtype)
    logw = p["w0"].float() + lo.float()
    return torch.exp(-torch.exp(logw))                        # (B, S, d)


def _groupnorm_heads(p, y, H, hd, eps=64e-5):
    """Layer norm of each head's hd values, in f32; returns f32."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, hd).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(B, S, d) * p["ln_g"].float() + p["ln_b"].float()


def timemix_inputs(p, x, cfg, x_prev_last=None):
    """The scan's inputs from x (B, S, d): r, k, v, w (B, S, H, hd) f32,
    u (H, hd) f32, and the gate g (B, S, d) in x's dtype."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_size
    mw, mk, mv, mr, mg = _ddlerp(p, x, _shifted(x, x_prev_last))
    w = _decay(p, mw).reshape(B, S, H, hd)
    r, k, v = (linear(p[name], m).reshape(B, S, H, hd).float().contiguous()
               for name, m in (("wr", mr), ("wk", mk), ("wv", mv)))
    g = F.silu(linear(p["wg"], mg))
    u = p["u"].float().reshape(H, hd).contiguous()
    return r, k, v, w.contiguous(), u, g


def timemix_out(p, x, cfg, y, g):
    """The block's output from the scan's y (B, S, H, hd) f32."""
    B, S, d = x.shape
    y = _groupnorm_heads(p, y.reshape(B, S, d), cfg.rwkv_heads,
                         cfg.rwkv_head_size).to(x.dtype)
    return linear(p["wo"], y * g)


def timemix_apply(p, x, cfg, x_prev_last=None, state=None):
    """x: (B, S, d); x_prev_last: (B, d) last token of the previous segment
    (decode); state: (B, H, hd, hd) f32.  Returns (out, (x_last, state)).

    A given ``state`` is updated **in place** to the final state and
    returned (the JAX package returns a new array); without one the scan
    starts from zero and the final state is a new tensor.  Where autograd
    records an input, the scan runs in ``cfg.rwkv_chunk``-step segments and
    is differentiable."""
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


def channelmix_apply(p, x, cfg, x_prev_last=None):
    """x: (B, S, d); x_prev_last: (B, d) or None.  Returns (out, x_last)."""
    xx = _shifted(x, x_prev_last) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(linear(p["wk"], xk)))
    r = torch.sigmoid(linear(p["wr"], xr))
    return r * linear(p["wv"], k), x[:, -1, :]


__all__ = ["channelmix_apply", "channelmix_init", "timemix_apply",
           "timemix_init", "timemix_inputs", "timemix_out"]
