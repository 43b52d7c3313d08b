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
  - ``compressed_psum_int8`` / ``compressed_psum_topk`` take a process
    group where the JAX package's take a ``shard_map`` axis name.
Under a mesh (``launch.train.Trainer(mesh=...)``) the gradients and the EF
buffers are DTensors placed like their parameters: each rank compresses
its own shards of the reduced gradients, as the JAX Trainer compresses its
sharded gradients; the wire is not compressed (neither package wires
``compressed_psum_*`` into a trainer).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import leaves, map_tree, unflatten
from repro_torch.kernels.quantize.ops import dequantize, quantize
from repro_torch.parallel.sharding import (all_sum, is_dtensor, like, local,
                                          place, replicas)

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


# ----------------------------------------------- compressed all-reduces ----
def compressed_psum_int8(x, group=None):
    """int8-compressed all-reduce: each rank's ``dequant(quant(x))`` (per
    row of a 2-d ``x``, one row of anything else), summed over ``group``
    by an f32 ``all_reduce``, in ``x``'s dtype.  On the card the pair runs
    through the quantize kernels."""
    import torch.distributed as dist

    rows = x if x.ndim == 2 else x.reshape(1, -1)
    q, scale = quant_int8(rows)
    total = dequant_int8(q, scale)
    dist.all_reduce(total, group=group)
    return total.reshape(x.shape).to(x.dtype)


def compressed_psum_topk(x, group=None, k_frac: float = 0.05):
    """top-k compressed all-reduce: each rank's densified top ``k_frac``
    entries, summed over ``group`` by an f32 ``all_reduce``."""
    import torch.distributed as dist

    vals, idx, n = topk_sparsify(x, k_frac)
    dense = topk_densify(vals, idx, n, x.shape)
    dist.all_reduce(dense, group=group)
    return dense.to(x.dtype)


# ------------------------------------------------------- error feedback -----
def _split(x) -> bool:
    """A DTensor whose shard on this rank is not the whole tensor."""
    return is_dtensor(x) and local(x).numel() != x.numel()


def _int8_round_trip(e, peak=None):
    """``dequant(quant(e))`` with ``e`` as one row; with ``peak`` (the
    absmax of the whole tensor ``e`` is a shard of) appended to the row, so
    the scale is the whole tensor's."""
    if peak is None:
        q, s = quantize(e.view(1, -1))
        return dequantize(q, s).view(e.shape)
    row = torch.empty((1, e.numel() + 1), dtype=e.dtype, device=e.device)
    row[0, :-1].copy_(e.view(-1))
    row[0, -1] = peak
    q, s = quantize(row)
    return dequantize(q[:, :-1], s).view(e.shape)

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
        return map_tree(lambda g: torch.zeros_like(
            g, dtype=torch.float32, memory_format=torch.contiguous_format),
            grads)

    def compress(self, grads: Any, ef: Any) -> tuple[Any, Any, dict]:
        """Returns (compressed-and-decompressed grads, ef, metrics); the EF
        buffers are updated in place and returned.  A DTensor leaf split
        over ranks is compressed as the whole tensor would be (the JAX
        package's GSPMD semantics): int8 with the tensor's own absmax (one
        all-reduce of every split leaf's peak a step; each shard quantized
        with that peak appended, so its scale is the tensor's), top-k over
        the gathered tensor."""
        g_leaves = leaves(grads)
        if self.method == "none":
            return grads, ef, {"compress_err": torch.zeros(
                (), dtype=torch.float32, device=local(g_leaves[0]).device)}
        e_leaves = leaves(ef)
        states = []
        for g_d, e_d in zip(g_leaves, e_leaves, strict=True):
            e = local(e_d)
            e.add_(local(g_d))                             # the state
            states.append(e)
        peaks = self._peaks(e_leaves, states) if self.method == "int8" \
            else {}
        sent, err = [], []
        for i, (g_d, e_d, e) in enumerate(zip(g_leaves, e_leaves, states)):
            if self.method == "int8":
                out = _int8_round_trip(e, peaks.get(i))
            elif _split(e_d):
                full = e_d.full_tensor()
                vals, idx, n = topk_sparsify(full, self.k_frac)
                out = local(place(topk_densify(vals, idx, n, full.shape),
                                  e_d.device_mesh, e_d.placements))
            else:
                vals, idx, n = topk_sparsify(e, self.k_frac)
                out = topk_densify(vals, idx, n, e.shape)
            e.sub_(out)                                    # state - sent
            sent.append(like(g_d, out.to(g_d.dtype)))
            sq = torch.linalg.vector_norm(e).square()
            err.append(sq if replicas(e_d) == 1 else sq / replicas(e_d))
        return unflatten(grads, sent), ef, {
            "compress_err": all_sum(torch.stack(err).sum(), ef)}

    @staticmethod
    def _peaks(e_leaves: list, states: list) -> dict:
        """{leaf index: the whole tensor's absmax} for the leaves split over
        ranks, from one MAX all-reduce of their shards' peaks."""
        split = [i for i, e_d in enumerate(e_leaves) if _split(e_d)]
        if not split:
            return {}
        import torch.distributed as dist
        amax = torch.stack([
            states[i].abs().amax().float() if states[i].numel()
            else states[i].new_zeros((), dtype=torch.float32)
            for i in split])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        return dict(zip(split, amax.unbind()))

    def wire_bytes_ratio(self) -> float:
        """Bytes on the wire vs dense f32 (for the collective roofline)."""
        if self.method == "int8":
            return 0.25
        if self.method == "topk":
            return 2.0 * self.k_frac          # values + indices
        return 1.0


__all__ = ["GradCompressor", "compressed_psum_int8", "compressed_psum_topk",
           "dequant_int8", "quant_int8", "topk_densify", "topk_sparsify"]
