"""Grouped matmul for the MoE expert FFNs: the CUDA kernel's wrapper.

The kernel (``csrc/moe_gmm.cu``) replaces the JAX package's Pallas kernel
``kernels/moe_gmm/kernel.py::moe_gmm`` (body ``_gmm_kernel``):
``out[e] = x[e] @ w[e]`` for every expert e, with f32 accumulation and the
result in x's dtype.  Unlike the TPU kernel it takes any row count M and
any d and f (the ragged edges are masked in the kernel), so the model hands
it the (E, G * C, d) rows of its capacity dispatch as they are.  Three
routes:
  - x bf16, w bf16: the tensor cores (Hopper's ``wgmma``, f32
    accumulation), fed by a ring of asynchronous copies;
  - x bf16, w f32: the same, with each weight rounded to bf16 once in
    shared memory (``__floats2bfloat162_rn``, bit for bit
    ``w.to(torch.bfloat16)``), so the model's f32 expert weights need no
    cast copy;
  - x f32, w f32: scalar f32 FMAs (exact f32 for the f32 configurations).
At the serving shapes (f32 weights) both a prefill launch and a decode
launch are bound by the bytes of the weights (see the source's note).

:func:`moe_gmm_cuda` checks its inputs and raises on anything the kernel
does not take; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["ROUTES", "moe_gmm_cuda"]

#: kernel dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (x dtype, w dtype) pairs the kernel takes
ROUTES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32))
_INT32_MAX = 2 ** 31 - 1
_MAX_EXPERTS = 65535                      # the grid's z extent


def _check(x, w) -> None:
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; x and w must lie on "
                             "one CUDA device")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if (x.dtype, w.dtype) not in ROUTES:
        raise TypeError(f"x {x.dtype} with w {w.dtype} is not a route of the "
                        f"kernel; it takes {ROUTES}")
    E, M, d = x.shape
    if w.shape[:2] != (E, d):
        raise ValueError(f"w {tuple(w.shape)} must be (E, d, f) = ({E}, {d}, "
                         "f)")
    if E > _MAX_EXPERTS or max(M, d, w.shape[2]) > _INT32_MAX:
        raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)} exceed "
                         f"the kernel's extents (E <= {_MAX_EXPERTS}, M, d, "
                         "f < 2**31)")


def moe_gmm_cuda(x, w):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    x: (E, M, d); w: (E, d, f); contiguous, on one CUDA device, dtypes one
    of :data:`ROUTES`.  Returns (E, M, f) in x's dtype.  Counts its launches
    in ``moe_gmm_cuda.launches``, and per (E, M, d, f) in
    ``moe_gmm_cuda.shapes``."""
    _check(x, w)
    E, M, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, M, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("moe_gmm")
    with torch.cuda.device(x.device):
        err = lib.moe_gmm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, d, f,
            _DTYPES[x.dtype], _DTYPES[w.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "moe_gmm")
    moe_gmm_cuda.launches += 1
    shapes = moe_gmm_cuda.shapes
    shapes[E, M, d, f] = shapes.get((E, M, d, f), 0) + 1
    return out


moe_gmm_cuda.launches = 0
moe_gmm_cuda.shapes = {}
