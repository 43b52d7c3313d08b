"""Plain PyTorch version of flash attention (naive O(S^2), f32 math).

The counterpart of the JAX package's ``kernels/flash_attention/ref.py``:
materialised f32 scores, a ``-1e30`` mask above the diagonal, softmax and
the PV product, and on request the rows' log-sum-exp that the training
backward reads.  The CPU path of :func:`~.ops.flash_attention`, the tests'
oracle, and what ``chip_smoke.py`` holds the CUDA kernel against on the
card.  Runs on any device.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, Kv, hd) with H % Kv == 0 -> (B, S, H,
    hd) in q.dtype; with ``return_lse`` also the log-sum-exp of each row's
    scaled scores, ``m + log(max(den, 1e-30))``, (B, S, H) f32.  The math
    is f32 (f64 for f64 inputs, as a gradient check needs)."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    wide = torch.promote_types(q.dtype, torch.float32)   # f64 stays f64
    qg = q.reshape(B, S, Kv, G, hd).to(wide)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(wide)) * (hd ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", p / den, v.to(wide))
    o = o.reshape(B, S, H, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(den.clamp(min=1e-30)))[..., 0]       # (B, Kv, G, S)
    return o, lse.permute(0, 3, 1, 2).reshape(B, S, H)


__all__ = ["NEG_INF", "attention_ref"]
