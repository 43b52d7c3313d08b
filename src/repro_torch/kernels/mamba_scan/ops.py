"""The selective scan, dispatched on the tensors' device.

``selective_scan(x, dt, Bmat, Cmat, A, D, h0=None, h_out=None)`` returns
(y (B, S, di) f32, h_final (B, di, ds) f32):
  - CUDA tensors launch the hand-written kernel (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch version (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
With ``h_out`` given, the final state is written there (it may be ``h0``
itself: the decode updates its cache in place) and returned.

``segmented_scan`` is the training path: the same scan over ``chunk``-step
segments under autograd (one launch a segment on the card; the backward
recomputes each segment with the plain version from its saved starting
state, :mod:`repro_torch.kernels._segments`).
"""
from __future__ import annotations

from repro_torch.kernels._segments import segmented

from .kernel import mamba_ssm_cuda
from .ref import mamba_ssm_ref


def selective_scan(x, dt, Bmat, Cmat, A, D, h0=None, h_out=None):
    """x, dt: (B, S, di); Bmat, Cmat: (B, S, ds); A: (di, ds); D: (di,);
    h0, h_out: (B, di, ds) or None -> (y, h_final)."""
    if x.device.type == "cuda":
        return mamba_ssm_cuda(x, dt, Bmat, Cmat, A, D, h0, h_out)
    if x.device.type == "cpu":
        y, h = mamba_ssm_ref(x, dt, Bmat, Cmat, A, D, h0)
        if h_out is not None:
            h = h_out.copy_(h)
        return y, h
    raise ValueError(f"selective_scan: no kernel for device {x.device}")


def segmented_scan(x, dt, Bmat, Cmat, A, D, h0=None, chunk: int = 64):
    """The selective scan over ``chunk``-step segments, differentiable with
    respect to every input (the JAX package's checkpointed ``ssm_scan``).
    Arguments as :func:`selective_scan`; returns (y, h_final), new
    tensors."""
    return segmented(selective_scan, mamba_ssm_ref, chunk,
                     (x, dt, Bmat, Cmat), (A, D), h0)


__all__ = ["segmented_scan", "selective_scan"]
