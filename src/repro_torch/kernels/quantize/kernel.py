"""Symmetric per-row int8 quantization: the CUDA kernels' wrappers.

The kernels (``csrc/quantize.cu``) replace the JAX package's Pallas
kernels ``kernels/quantize/kernel.py::quantize_int8`` (body
``_quant_kernel``) and ``::dequantize_int8`` (body ``_dequant_kernel``).
The gradient-compression chain quantizes each parameter tensor as one row
of up to 622 M elements.  Quantize is one persistent cooperative launch:
each block streams its share of the elements through a ring of
shared-memory tiles (bulk copies on mbarriers) and folds each row's max
into the amax scratch with ``atomicMax`` on its bit pattern; after a
grid-wide barrier it rounds the tiles it still holds, then re-reads the
rest of its share back to front, so what L2 still holds comes first.
Dequantize is one elementwise pass.  Both are bound by bytes (5 an element
in f32; quantize moves 9 for what the card could not hold between its
phases).  The TPU wrappers' ``block_rows`` tiling has no counterpart: the
kernels pick their own grid for any (R, D).  Results are bit for bit those
of the plain version (:mod:`.ref`).

The wrappers check their inputs and raise on anything the kernels do not
take; they never fall back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["SLOTS", "TILE_BYTES", "dequantize_int8_cuda",
           "quantize_int8_cuda"]

#: kernel dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: bytes of one quantize tile and tiles a block holds in shared memory
#: between its phases (``kTileBytes``, ``kSlots`` in the source)
TILE_BYTES = 65536
SLOTS = 3


def _require(t, name: str, dtypes, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} is on {t.device}; the kernels take tensors "
                         "on one CUDA device")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {sorted(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def quantize_int8_cuda(x):
    """Launch the quantize kernel on the current stream (no
    synchronisation).  x: (R, D) f32 or bf16, contiguous, on a CUDA device.
    Returns (q (R, D) int8, scale (R, 1) f32).  Counts its launches in
    ``quantize_int8_cuda.launches``, and by (R, D) in
    ``quantize_int8_cuda.shapes``."""
    _require(x, "x", _DTYPES)
    R, D = x.shape
    q = torch.empty((R, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    if R == 0:
        return q, scale
    amax = torch.zeros((R,), dtype=torch.int32, device=x.device)
    lib = _build.library("quantize")
    with torch.cuda.device(x.device):
        err = lib.quantize_int8_launch(
            x.data_ptr(), _DTYPES[x.dtype], q.data_ptr(), scale.data_ptr(),
            amax.data_ptr(), R, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_int8")
    quantize_int8_cuda.launches += 1
    shapes = quantize_int8_cuda.shapes
    shapes[R, D] = shapes.get((R, D), 0) + 1
    return q, scale


def dequantize_int8_cuda(q, scale, dtype=torch.float32):
    """Launch the dequantize kernel on the current stream (no
    synchronisation).  q: (R, D) int8; scale: (R, 1) f32; both contiguous on
    one CUDA device; ``dtype`` f32 or bf16.  Returns (R, D) ``dtype``.
    Counts its launches in ``dequantize_int8_cuda.launches``."""
    _require(q, "q", (torch.int8,))
    _require(scale, "scale", (torch.float32,), q.device)
    R, D = q.shape
    if tuple(scale.shape) != (R, 1):
        raise ValueError(f"scale has shape {tuple(scale.shape)}, expected "
                         f"({R}, 1)")
    if dtype not in _DTYPES:
        raise TypeError(f"dtype must be torch.float32 or torch.bfloat16, got "
                        f"{dtype}")
    out = torch.empty((R, D), dtype=dtype, device=q.device)
    if R == 0 or D == 0:
        return out
    lib = _build.library("quantize")
    with torch.cuda.device(q.device):
        err = lib.dequantize_int8_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPES[dtype],
            R, D, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "dequantize_int8")
    dequantize_int8_cuda.launches += 1
    return out


quantize_int8_cuda.launches = 0
quantize_int8_cuda.shapes = {}
dequantize_int8_cuda.launches = 0
