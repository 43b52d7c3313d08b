"""Plain PyTorch version of the selective scan (sequential, f32; f64 for
f64 x, which the gradient checks use).

The counterpart of the JAX package's ``kernels/mamba_scan/ref.py``,
extended as the model's ``ssm_scan`` (``models/mamba.py``) needs it: it
starts from ``h0`` (zero when none is given) and returns the final state
beside y.  y stays f32: with h0 = 0 and y cast to x's dtype it is the JAX
oracle.  The CPU path of :func:`~.ops.selective_scan`, the tests' oracle,
and what ``chip_smoke.py`` holds the CUDA kernel against on the card.  Runs
on any device.
"""
from __future__ import annotations

import torch


def mamba_ssm_ref(x, dt, Bmat, Cmat, A, D, h0=None):
    """x, dt: (B, S, di); Bmat, Cmat: (B, S, ds); A: (di, ds); D: (di,);
    h0: (B, di, ds) or None.  Returns y (B, S, di) f32 and h_final (B, di,
    ds) f32 (f64 for f64 x)."""
    B, S, di = x.shape
    ds = Bmat.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    h = torch.zeros((B, di, ds), dtype=acc, device=x.device) \
        if h0 is None else h0.to(acc)
    A, D = A.to(acc), D.to(acc)
    ys = []
    for t in range(S):
        xt, dtt, Bt, Ct = (a[:, t].to(acc) for a in (x, dt, Bmat, Cmat))
        dA = torch.exp(dtt[..., None] * A[None])
        dBx = (dtt * xt)[..., None] * Bt[:, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bds,bs->bd", h, Ct) + D[None] * xt)
    y = torch.stack(ys, 1) if ys else torch.zeros(
        (B, 0, di), dtype=acc, device=x.device)
    return y, h


__all__ = ["mamba_ssm_ref"]
