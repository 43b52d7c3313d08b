"""Plain PyTorch version of flash attention (naive O(S^2), f32 math).

The counterpart of the JAX package's ``kernels/flash_attention/ref.py``:
materialised f32 scores, a ``-1e30`` mask above the diagonal, softmax and
the PV product.  The CPU path of :func:`~.ops.flash_attention`, the tests'
oracle, and what ``chip_smoke.py`` holds the CUDA kernel against on the
card.  Runs on any device.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, S, Kv, hd) with H % Kv == 0 -> (B, S, H,
    hd) in q.dtype."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (hd ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


__all__ = ["NEG_INF", "attention_ref"]
