"""Mamba (S6) selective scan: the CUDA kernel's wrapper.

The kernel (``csrc/mamba_scan.cu``) replaces the JAX package's Pallas
kernel ``kernels/mamba_scan/kernel.py::mamba_ssm`` (body ``_mamba_kernel``)
and extends it as the model's ``ssm_scan`` needs: it starts from a carried
state ``h0`` and returns the final state beside y, so a prefill leaves the
state in the cache and each decode step is a scan of one step from it.
Four lanes own one (batch, channel), 4 of its 16 states each in
registers, and sum y over them with shuffles, 4 steps at a time; chunks of
x, dt, B and C are kept in flight with ``cp.async``.  All in f32, the
exponentials as ``exp2f`` of a prescaled A (no fast math).  At the serving
shapes it is bound about evenly by its exponentials and its bytes.

:func:`mamba_ssm_cuda` checks its inputs and raises on anything the kernel
does not take; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["D_STATES", "mamba_ssm_cuda"]

#: d_state values the kernel is instantiated for
D_STATES = (16,)
_INT32_MAX = 2 ** 31 - 1
_MAX_BATCH = 65535                        # the grid's y extent


def _check(x, dt, Bmat, Cmat, A, D, h0, h_out) -> None:
    named = [("x", x), ("dt", dt), ("Bmat", Bmat), ("Cmat", Cmat), ("A", A),
             ("D", D), ("h0", h0), ("h_out", h_out)]
    for name, t in named:
        if t is None and name in ("h0", "h_out"):
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; every input must lie "
                             "on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, di), got {tuple(x.shape)}")
    B, S, di = x.shape
    ds = Bmat.shape[-1] if Bmat.dim() == 3 else -1
    want = {"dt": (B, S, di), "Bmat": (B, S, ds), "Cmat": (B, S, ds),
            "A": (di, ds), "D": (di,), "h0": (B, di, ds),
            "h_out": (B, di, ds)}
    for name, t in named[1:]:
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
    if ds not in D_STATES:
        raise ValueError(f"d_state {ds} not supported; the kernel is built "
                         f"for {D_STATES}")
    if B > _MAX_BATCH or max(S, di) > _INT32_MAX:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's extents "
                         f"(B <= {_MAX_BATCH}, S, di < 2**31)")


def mamba_ssm_cuda(x, dt, Bmat, Cmat, A, D, h0=None, h_out=None):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    x, dt: (B, S, di); Bmat, Cmat: (B, S, 16); A: (di, 16); D: (di,); h0
    and h_out: (B, di, 16) or None; all f32, contiguous, on one CUDA device.
    Returns (y (B, S, di), h_final): h_final is ``h_out`` when given (it may
    be ``h0`` itself), else a new tensor.  Counts its launches in
    ``mamba_ssm_cuda.launches``, and per (B, S) in
    ``mamba_ssm_cuda.shapes``."""
    _check(x, dt, Bmat, Cmat, A, D, h0, h_out)
    B, S, di = x.shape
    ds = Bmat.shape[-1]
    y = torch.empty_like(x)
    if h_out is None:
        h_out = torch.empty((B, di, ds), dtype=torch.float32,
                            device=x.device)
    if B == 0 or di == 0:
        return y, h_out
    lib = _build.library("mamba_scan")
    with torch.cuda.device(x.device):
        err = lib.mamba_ssm_launch(
            x.data_ptr(), dt.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), B, S, di, ds,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mamba_ssm")
    mamba_ssm_cuda.launches += 1
    shapes = mamba_ssm_cuda.shapes
    shapes[B, S] = shapes.get((B, S), 0) + 1
    return y, h_out


mamba_ssm_cuda.launches = 0
mamba_ssm_cuda.shapes = {}
