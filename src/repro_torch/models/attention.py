"""Grouped-query attention for serving: the prefill and decode part of the
JAX package's ``models/attention.py``.

Entry points per layer:
  - ``attn_prefill`` : full-sequence causal attention that also returns the
                       layer's K/V, through the hand-written CUDA kernel on
                       the card (:mod:`repro_torch.kernels.flash_attention`)
                       and its plain version on the CPU
  - ``attn_decode``  : one new token against a (possibly longer) KV cache,
                       plain PyTorch as in the JAX package, which computes
                       it outside any Pallas kernel

The JAX package's custom-vjp backward and ``attn_train`` belong to the
training slice (ROADMAP Queue 1).  Its ``causal_attention`` pads S to a
block multiple for the XLA fallback; the CUDA kernel masks the ragged edge
of S itself, so nothing pads here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .layers import (apply_mrope, apply_rope, linear, linear_init, rmsnorm,
                     rmsnorm_init)

NEG_INF = -1e30


def attn_init(gen, cfg, dtype=torch.float32, device=None):
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": linear_init(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, d, Kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, d, Kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, H * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, **kw)
        p["k_norm"] = rmsnorm_init(hd, **kw)
    return p


def _project_qkv(p, x, cfg, positions):
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, Kv, hd), contiguous;
    qk-norm (where the config has it) comes before RoPE."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, Kv, hd)
    v = linear(p["wv"], x).reshape(B, S, Kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def causal_attention(q, k, v):
    """Causal GQA attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  q (B, S, H, hd); k, v (B, S, Kv, hd)."""
    return flash_attention(q, k, v, causal=True)


def attn_prefill(p, x, cfg, positions):
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = causal_attention(q, k, v)
    B, S, _, _ = o.shape
    return linear(p["wo"], o.reshape(B, S, -1)), (k, v)


def decode_attention(q, k_cache, v_cache, kv_len: int):
    """q: (B, 1, H, hd); caches: (B, S_max, Kv, hd); kv_len: valid prefix
    length.  Scores and the PV sum in f32; the normalised probabilities are
    rounded to the cache's dtype before the PV product, as in the JAX
    package."""
    B, Smax, Kv, hd = k_cache.shape
    H = q.shape[2]
    G = H // Kv
    scale = hd ** -0.5
    qg = q.reshape(B, Kv, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    pos = torch.arange(Smax, device=q.device)
    s = torch.where(pos[None, None, None, :] < kv_len, s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    pv = (p / denom).to(v_cache.dtype).float()
    o = torch.einsum("bkgt,btkd->bkgd", pv, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attn_decode(p, x, cfg, k_cache, v_cache, pos: int):
    """x: (B, 1, d); caches (B, S_max, Kv, hd); pos: the current position.

    Writes the new token's K/V into the caches **in place** (the JAX
    package returns updated copies and donates the old ones) and returns
    (y, k_cache, v_cache).  Like ``jax.lax.dynamic_update_slice``, the write
    index is clamped to ``S_max - 1``; the mask keeps ``pos + 1`` keys.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections:  # text-only decode: all three M-RoPE indices = pos
        positions = positions.expand(3, B, 1)
    q, k, v = _project_qkv(p, x, cfg, positions)
    at = min(max(pos, 0), k_cache.shape[1] - 1)
    k_cache[:, at] = k[:, 0].to(k_cache.dtype)
    v_cache[:, at] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    y = linear(p["wo"], o.reshape(B, 1, -1))
    return y, k_cache, v_cache


__all__ = ["NEG_INF", "attn_decode", "attn_init", "attn_prefill",
           "causal_attention", "decode_attention"]
