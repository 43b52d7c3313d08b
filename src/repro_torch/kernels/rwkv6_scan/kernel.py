"""RWKV-6 WKV recurrence: the CUDA kernel's wrapper.

The kernel (``csrc/rwkv6_scan.cu``) computes what the JAX package's Pallas
kernel ``kernels/rwkv6_scan/kernel.py::rwkv6_wkv`` (body ``_wkv_kernel``)
computes, extended as serving needs it: it starts from a carried state
(``state0``, zero when none is given), writes the final state (which may be
``state0`` itself, so the decode updates its cache in place), takes the
model's (B, S, H, hd) layout and any S.  A (batch, head) pair's columns
are split over 2 to 8 blocks; the 8 (at hd 64) threads of a column each
keep 8 of its rows of the (hd, hd) state in registers and sum y over them
with shuffles, 8 steps at a time.  A staging warp keeps chunks of r, k, v,
w in flight with ``cp.async`` and computes the bonus term once a step.
All in f32, no fast math.

:func:`rwkv6_wkv_cuda` checks its inputs and raises on anything the kernel
does not take; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["HEAD_SIZES", "rwkv6_wkv_cuda"]

#: head sizes the kernel is instantiated for (the reference tests' and
#: rwkv6-3b's)
HEAD_SIZES = (16, 32, 64)
_INT32_MAX = 2 ** 31 - 1


def _check(r, k, v, w, u, state0, state_out) -> None:
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state0", state0), ("state_out", state_out)]
    for name, t in named:
        if t is None and name in ("state0", "state_out"):
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != r.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every input must lie "
                             "on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hd), got {tuple(r.shape)}")
    B, S, H, hd = r.shape
    want = {"k": (B, S, H, hd), "v": (B, S, H, hd), "w": (B, S, H, hd),
            "u": (H, hd), "state0": (B, H, hd, hd),
            "state_out": (B, H, hd, hd)}
    for name, t in named[1:]:
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"head size {hd} not supported; the kernel is built "
                         f"for {HEAD_SIZES}")
    if H == 0 or max(S, B * H) > _INT32_MAX:
        raise ValueError(f"r {tuple(r.shape)} exceeds the kernel's extents "
                         "(H >= 1; S, B * H < 2**31)")


def rwkv6_wkv_cuda(r, k, v, w, u, state0=None, state_out=None):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    r, k, v, w: (B, S, H, hd); u: (H, hd); state0 and state_out: (B, H, hd,
    hd) or None; all f32, contiguous, on one CUDA device; hd in
    :data:`HEAD_SIZES`.  Returns (y (B, S, H, hd), state_final):
    state_final is ``state_out`` when given (it may be ``state0`` itself),
    else a new tensor.  Counts its launches in ``rwkv6_wkv_cuda.launches``,
    and per (B, S) in ``rwkv6_wkv_cuda.shapes``."""
    _check(r, k, v, w, u, state0, state_out)
    B, S, H, hd = r.shape
    y = torch.empty_like(r)
    if state_out is None:
        state_out = torch.empty((B, H, hd, hd), dtype=torch.float32,
                                device=r.device)
    if B == 0:
        return y, state_out
    lib = _build.library("rwkv6_scan")
    with torch.cuda.device(r.device):
        err = lib.rwkv6_wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state_out.data_ptr(), B, S, H, hd,
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "rwkv6_wkv")
    rwkv6_wkv_cuda.launches += 1
    shapes = rwkv6_wkv_cuda.shapes
    shapes[B, S] = shapes.get((B, S), 0) + 1
    return y, state_out


rwkv6_wkv_cuda.launches = 0
rwkv6_wkv_cuda.shapes = {}
