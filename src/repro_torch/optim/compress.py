"""Gradient-stream NT chains: compression applied to the data-parallel
gradient exchange, with error feedback.

The training-side instance of the paper's NT-chain idea: each gradient
tensor is a "packet"; the chain
    [quantize-int8 | top-k]  ->  all-reduce  ->  [dequantize | scatter]
is the NT sequence it traverses, and the error-feedback (EF) buffer is the
NT's on-board state.  ``GradCompressor`` carries the EF tree across steps.

``quant_int8`` / ``dequant_int8`` go through :mod:`repro_torch.kernels.
quantize`: the hand-written CUDA kernels for CUDA tensors, the plain
versions for CPU tensors (the JAX package runs the same math in plain jnp
here).  Differences from the JAX package that change no result:
  - the int8 EF buffer is updated in place (``e += g``, quantize, ``e -=
    sent``), which saves one tensor-sized temporary;
  - ``compress_err`` sums each buffer's squared norm;
  - ``compressed_psum_int8`` / ``compressed_psum_topk`` run inside
    ``shard_map`` over a mesh and are not ported (ROADMAP Queue 1 #7).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import leaves, map_tree, unflatten
from repro_torch.kernels.quantize.ops import dequantize, quantize

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------------ primitives ----
def quant_int8(x):
    """x (..., D) -> (q int8, scale (..., 1) f32).  Symmetric per-row."""
    if x.dtype not in _KERNEL_DTYPES:
        x = x.float()
    D = x.shape[-1]
    q, scale = quantize(x.reshape(-1, D).contiguous())
    return q.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def dequant_int8(q, scale, dtype=torch.float32):
    D = q.shape[-1]
    out = dequantize(q.reshape(-1, D).contiguous(), scale.reshape(-1, 1),
                     dtype if dtype in _KERNEL_DTYPES else torch.float32)
    return out.reshape(q.shape).to(dtype)


def topk_sparsify(x, k_frac: float):
    """Keep the top ``k_frac`` fraction (by |value|) of a flat vector.
    Ties in |x| may pick other indices than ``jax.lax.top_k``."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * k_frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, flat.shape[0]


def topk_densify(vals, idx, n, shape, dtype=torch.float32):
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out.reshape(shape).to(dtype)


# ------------------------------------------------------- error feedback -----
class GradCompressor:
    """Error-feedback gradient compression (1-bit-Adam/EF-SGD style).

    state_t = g_t + e_{t-1};  sent_t = C(state_t);  e_t = state_t - sent_t.
    ``method``: "none" | "int8" | "topk".
    """

    def __init__(self, method: str = "int8", k_frac: float = 0.05):
        assert method in ("none", "int8", "topk")
        self.method = method
        self.k_frac = k_frac

    def init(self, grads: Any) -> Any:
        if self.method == "none":
            return None
        return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    def compress(self, grads: Any, ef: Any) -> tuple[Any, Any, dict]:
        """Returns (compressed-and-decompressed grads, ef, metrics); the EF
        buffers are updated in place and returned."""
        g_leaves = leaves(grads)
        if self.method == "none":
            return grads, ef, {"compress_err": torch.zeros(
                (), dtype=torch.float32, device=g_leaves[0].device)}
        sent, err = [], []
        for g, e in zip(g_leaves, leaves(ef), strict=True):
            e.add_(g)                                      # the state
            if self.method == "int8":
                q, s = quantize(e.view(1, -1))
                out = dequantize(q, s).view(e.shape)
            else:
                vals, idx, n = topk_sparsify(e, self.k_frac)
                out = topk_densify(vals, idx, n, e.shape)
            e.sub_(out)                                    # state - sent
            sent.append(out.to(g.dtype))
            err.append(torch.linalg.vector_norm(e).square())
        return unflatten(grads, sent), ef, {
            "compress_err": torch.stack(err).sum()}

    def wire_bytes_ratio(self) -> float:
        """Bytes on the wire vs dense f32 (for the collective roofline)."""
        if self.method == "int8":
            return 0.25
        if self.method == "topk":
            return 2.0 * self.k_frac          # values + indices
        return 1.0


__all__ = ["GradCompressor", "dequant_int8", "quant_int8", "topk_densify",
           "topk_sparsify"]
