"""Plain PyTorch version of the RWKV-6 WKV recurrence (sequential).

The counterpart of the JAX package's ``kernels/rwkv6_scan/ref.py``, in the
layout and with the carried state that the model's ``wkv_scan``
(``models/rwkv6.py``) uses: r, k, v, w are (B, S, H, hd), the state is
(B, H, hd, hd) with the k dimension first, and the final state is returned
beside y.  A loop over t mirrors ``_wkv_step``:

    y_t = r_t^T (S + diag(u) k_t v_t^T)
    S  <- diag(w_t) S + k_t v_t^T

With a zero state and the layout permuted it is the JAX oracle.  The CPU
path of :func:`~.ops.wkv`, the tests' oracle, and what ``chip_smoke.py``
holds the CUDA kernel against on the card.  Runs on any device and
computes in r's dtype: f32 on the model's path; ``chip_smoke.py`` also runs
it in f64 and bf16 to see how far scans that round differently drift apart
end to end.
"""
from __future__ import annotations

import torch


def rwkv6_wkv_ref(r, k, v, w, u, state=None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) or None
    (zero).  Returns y (B, S, H, hd) and the final state (B, H, hd, hd),
    both in r's dtype."""
    B, S, H, hd = r.shape
    dt = r.dtype
    st = torch.zeros((B, H, hd, hd), dtype=dt, device=r.device) \
        if state is None else state.to(dt)
    u = u.to(dt)[None, :, :, None]                        # (1, H, hd, 1)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (a[:, t].to(dt) for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]          # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, st + u * kv))
        st = wt[..., :, None] * st + kv
    y = torch.stack(ys, 1) if ys else torch.zeros(
        (B, 0, H, hd), dtype=dt, device=r.device)
    return y, st


__all__ = ["rwkv6_wkv_ref"]
