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
The scan is one ``torch.library`` op, ``repro_torch::mamba_ssm`` (it writes
the final state into ``h_out``, allocated here when not given), so a
fake-tensor trace (the dry run) sees one op a launch and the scan's FLOP:
7 a state element and step (the exponential counted as one) and 3 a
channel and step.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._segments import segmented

from .kernel import mamba_ssm_cuda
from .ref import mamba_ssm_ref


@torch.library.custom_op("repro_torch::mamba_ssm", mutates_args=("h_out",))
def _scan_op(x: torch.Tensor, dt: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor | None, h_out: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        y, h = mamba_ssm_cuda(x, dt, Bmat, Cmat, A, D, h0, h_out)
    else:
        y, h = mamba_ssm_ref(x, dt, Bmat, Cmat, A, D, h0)
    if h is not h_out:      # the plain version (or a stand-in for the kernel)
        h_out.copy_(h)
    return y


@_scan_op.register_fake
def _(x, dt, Bmat, Cmat, A, D, h0, h_out):
    return x.new_empty(x.shape, dtype=torch.promote_types(x.dtype,
                                                          torch.float32))


@register_flop_formula(torch.ops.repro_torch.mamba_ssm)
def mamba_ssm_flop(x_shape, dt_shape, b_shape, c_shape, a_shape, *args,
                   **kwargs) -> int:
    B, S, di = x_shape
    return B * S * di * (7 * a_shape[1] + 3)


def selective_scan(x, dt, Bmat, Cmat, A, D, h0=None, h_out=None):
    """x, dt: (B, S, di); Bmat, Cmat: (B, S, ds); A: (di, ds); D: (di,);
    h0, h_out: (B, di, ds) or None -> (y, h_final)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"selective_scan: no kernel for device {x.device}")
    if h_out is None:      # the kernel's f32; the plain version's dtype
        h_out = torch.empty((x.shape[0], x.shape[2], A.shape[1]),
                            dtype=torch.promote_types(x.dtype, torch.float32),
                            device=x.device)
    return _scan_op(x, dt, Bmat, Cmat, A, D, h0, h_out), h_out


def segmented_scan(x, dt, Bmat, Cmat, A, D, h0=None, chunk: int = 64):
    """The selective scan over ``chunk``-step segments, differentiable with
    respect to every input (the JAX package's checkpointed ``ssm_scan``).
    Arguments as :func:`selective_scan`; returns (y, h_final), new
    tensors."""
    return segmented(selective_scan, mamba_ssm_ref, chunk,
                     (x, dt, Bmat, Cmat), (A, D), h0)


__all__ = ["mamba_ssm_flop", "segmented_scan", "selective_scan"]
