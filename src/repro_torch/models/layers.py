"""Shared neural-net building blocks: the JAX package's ``models/layers.py``
as plain functions on tensors.

Conventions (as in the JAX package):
  - activations are (batch, seq, d_model); attention internals (B, S, H, hd).
  - params are nested dicts of tensors; every module has <name>_init / <name>
    apply.  Initialisers draw from an explicit ``torch.Generator`` (their
    numbers differ from ``jax.random``'s; tests carry weights across with
    :func:`repro_torch.convert.model_params_from_numpy`).
  - compute dtype is controlled by the caller (configs set bf16 for
    production, f32 for CPU smoke tests); norms and RoPE compute in f32.

``chunked_softmax_xent`` is the training loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 tensor drawn from ``gen`` (on the generator's own
    device) and placed on ``device``."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.to(device)


# ---------------------------------------------------------------- linear ----
def linear_init(gen, in_dim: int, out_dim: int, *, bias: bool = False,
                scale: float | None = None, dtype=torch.float32, device=None):
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    p = {"w": normal(gen, (in_dim, out_dim), device).mul_(scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def linear(p, x):
    """``x @ w`` with the weight cast to ``x.dtype`` at use, as in JAX."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ----------------------------------------------------------------- norms ----
def rmsnorm_init(dim: int, dtype=torch.float32, device=None):
    return {"g": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    # reduce in f32 for stability regardless of compute dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None):
    return {"g": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def norm_init(kind: str, dim: int, dtype=torch.float32, device=None):
    return layernorm_init(dim, dtype, device) if kind == "layernorm" else \
        rmsnorm_init(dim, dtype, device)


def norm_apply(kind: str, p, x):
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)


# ------------------------------------------------------------- embedding ----
def embed_init(gen, vocab: int, dim: int, dtype=torch.float32, device=None):
    return {"table": normal(gen, (vocab, dim), device).mul_(0.02).to(dtype)}


def embed(p, ids):
    return p["table"][ids.long()]


# ------------------------------------------------------------------ RoPE ----
def _rope_sincos(positions, rot_dim: int, theta: float):
    """positions (...,) -> sin/cos of shape positions.shape + (rot_dim//2,)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq          # (..., rot/2)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) or (S,). Rotates the full head
    dim, the two halves as the pair (split, not interleaved)."""
    hd = x.shape[-1]
    if positions.dim() == 1:
        positions = positions[None, :]
    sin, cos = _rope_sincos(positions, hd, theta)          # (B, S, hd/2)
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: tuple[int, ...]):
    """Multimodal RoPE (Qwen2-VL). positions3: (3, B, S) [t, h, w] indices.

    ``sections`` gives the per-modality share of rotary *pairs*; must sum to
    hd//2.  Each frequency band takes its angle from its modality's
    positions (the JAX package selects with a one-hot product; here the
    selection is an index, which is exact too)."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    inv_freq = 1.0 / (theta ** exps)
    ang = positions3.float()[..., None] * inv_freq         # (3, B, S, half)
    sect = torch.tensor([i for i, n in enumerate(sections)
                         for _ in range(n)], device=x.device)   # (half,)
    ang = ang[sect, :, :, torch.arange(half, device=x.device)]  # (half,B,S)
    ang = ang.permute(1, 2, 0)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP ----
def mlp_init(gen, d: int, d_ff: int, kind: str = "swiglu",
             dtype=torch.float32, device=None):
    if kind == "swiglu":
        return {"gate": linear_init(gen, d, d_ff, dtype=dtype, device=device),
                "up": linear_init(gen, d, d_ff, dtype=dtype, device=device),
                "down": linear_init(gen, d_ff, d, dtype=dtype, device=device)}
    # classic transformer MLP (GELU)
    return {"up": linear_init(gen, d, d_ff, dtype=dtype, device=device),
            "down": linear_init(gen, d_ff, d, dtype=dtype, device=device)}


def mlp(p, x, kind: str = "swiglu"):
    if kind == "swiglu":
        return linear(p["down"],
                      F.silu(linear(p["gate"], x)) * linear(p["up"], x))
    # jax.nn.gelu defaults to the tanh approximation
    return linear(p["down"], F.gelu(linear(p["up"], x), approximate="tanh"))


# ------------------------------------------------- chunked cross-entropy ----
def chunked_softmax_xent(x, head_w, labels, *, chunk: int = 512,
                         label_smoothing: float = 0.0):
    """Cross-entropy over a huge vocab without materialising (B, S, V).

    x: (B, S, D) final hidden states; head_w: (D, V); labels: (B, S) int.
    The sequence is cut into chunks as the JAX package's scan cuts it, and
    each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``), so at most one (B, chunk, V) block of f32
    logits is alive.  Returns the mean loss over all tokens (labels ==
    -100 are masked out).
    """
    B, S, D = x.shape
    V = head_w.shape[1]
    nchunk = max(1, S // chunk)
    assert S % nchunk == 0, (S, chunk)
    csz = S // nchunk

    def body(xx, ll):
        logits = (xx @ head_w.to(xx.dtype)).float()       # (B, c, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ll.clamp(0, V - 1).long()[..., None])[..., 0]
        if label_smoothing:
            gold = (1 - label_smoothing) * gold + \
                label_smoothing * logits.mean(-1)
        mask = (ll >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nchunk):
        part = slice(i * csz, (i + 1) * csz)
        t, c = checkpoint(body, x[:, part], labels[:, part],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp(min=1.0)


__all__ = ["apply_mrope", "apply_rope", "chunked_softmax_xent", "embed",
           "embed_init", "layernorm", "layernorm_init", "linear",
           "linear_init", "mlp", "mlp_init", "norm_apply", "norm_init",
           "normal", "rmsnorm", "rmsnorm_init"]
