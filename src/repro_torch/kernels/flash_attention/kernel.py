"""Flash attention forward: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
kernel ``kernels/flash_attention/kernel.py::flash_attention_grouped`` (body
``_fa_kernel``): causal or full GQA forward attention with an f32 online
softmax over kv tiles, and on request the rows' log-sum-exp, which the
training backward (``models/attention.py``) reads.  It reads the model's
(B, S, H, hd) / (B, S, Kv, hd) layouts directly, so the TPU wrapper's
transposes to (B, Kv, G, S, hd) have no counterpart here.  One block owns
a (batch, kv head, query tile) and all G = H / Kv heads of the group, and
stages each K/V tile in shared memory once for them.  At the serving and
training shapes it is bound by arithmetic (the tensor cores' bf16 rate).
bf16 inputs run on the tensor cores (``mma.sync``, f32 accumulation, K and
V through a ring of asynchronous copies), f32 inputs on scalar f32 FMAs (see
the source's note and ``PERF.md``).

:func:`flash_attention_cuda` checks its inputs and raises on anything the
kernel does not take; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["HEAD_DIMS", "MAX_GROUP", "flash_attention_cuda"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128, 160)
#: largest H / Kv: a block holds all G heads of its queries (128 (query,
#: head) rows in the bf16 body, 64 in the f32 one)
MAX_GROUP = 64
#: kernel dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; q, k and v must lie "
                             "on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} is {t.dtype}; q, k and v must all be "
                            "torch.float32 or all torch.bfloat16")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, S, Kv, hd) = ({B}, {S}, Kv, {hd})")
    Kv = k.shape[2]
    if Kv == 0 or H % Kv or H // Kv > MAX_GROUP:
        raise ValueError(f"H = {H} must be a multiple of Kv = {Kv} with "
                         f"H / Kv <= {MAX_GROUP}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; the kernel is built "
                         f"for {HEAD_DIMS}")


def flash_attention_cuda(q, k, v, causal: bool = True,
                         return_lse: bool = False):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    q: (B, S, H, hd); k, v: (B, S, Kv, hd); contiguous, one dtype (f32 or
    bf16), on one CUDA device.  Returns (B, S, H, hd) in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exp (B, S, H) f32, which the
    kernel writes beside the output.  Counts its launches in
    ``flash_attention_cuda.launches``, and per (B, S) in
    ``flash_attention_cuda.shapes``."""
    _check(q, k, v)
    out = torch.empty_like(q)
    B, S, H, hd = q.shape
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B == 0 or S == 0:
        return (out, lse) if return_lse else out
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, S, H, k.shape[2], hd,
            _DTYPES[q.dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    shapes = flash_attention_cuda.shapes
    shapes[B, S] = shapes.get((B, S), 0) + 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.shapes = {}
