"""Plain PyTorch version of the grouped matmul (one f32 einsum).

The counterpart of the JAX package's ``kernels/moe_gmm/ref.py``:
``out[e] = x[e] @ w[e]`` in f32 (in f64 for f64 x, which the gradient
checks use), cast back to ``x.dtype``.  The weights are
first rounded to ``x.dtype``, as the model casts them at use
(``p["gate"].astype(x.dtype)``); for weights already in ``x.dtype`` that is
the JAX oracle exactly.  The CPU path of :func:`~.ops.grouped_matmul`, the
tests' oracle, and what ``chip_smoke.py`` holds the CUDA kernel against on
the card.  Runs on any device.
"""
from __future__ import annotations

import torch


def moe_gmm_ref(x, w):
    """x: (E, M, d); w: (E, d, f) -> (E, M, f) in x.dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum("ecd,edf->ecf", x.to(acc),
                        w.to(x.dtype).to(acc)).to(x.dtype)


__all__ = ["moe_gmm_ref"]
