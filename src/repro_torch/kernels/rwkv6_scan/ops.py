"""The WKV recurrence, dispatched on the tensors' device.

``wkv(r, k, v, w, u, state=None, state_out=None)`` returns (y (B, S, H, hd)
f32, state_final (B, H, hd, hd) f32):
  - CUDA tensors launch the hand-written kernel (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch version (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
With ``state_out`` given, the final state is written there (it may be
``state`` itself: the decode updates its cache in place) and returned.

``segmented_wkv`` is the training path: the same recurrence over
``chunk``-step segments under autograd (one launch a segment on the card;
the backward recomputes each segment with the plain version from its saved
starting state, :mod:`repro_torch.kernels._segments`).
The recurrence is one ``torch.library`` op, ``repro_torch::rwkv6_wkv`` (it
writes the final state into ``state_out``, allocated here when not given),
so a fake-tensor trace (the dry run) sees one op a launch and the
recurrence's FLOP: 7 a state element and step.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._segments import segmented

from .kernel import rwkv6_wkv_cuda
from .ref import rwkv6_wkv_ref


@torch.library.custom_op("repro_torch::rwkv6_wkv",
                         mutates_args=("state_out",))
def _wkv_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state: torch.Tensor | None,
            state_out: torch.Tensor) -> torch.Tensor:
    if r.device.type == "cuda":
        y, st = rwkv6_wkv_cuda(r, k, v, w, u, state, state_out)
    else:
        y, st = rwkv6_wkv_ref(r, k, v, w, u, state)
    if st is not state_out:  # the plain version (or a stand-in for the kernel)
        state_out.copy_(st)
    return y


@_wkv_op.register_fake
def _(r, k, v, w, u, state, state_out):
    return r.new_empty(r.shape)


@register_flop_formula(torch.ops.repro_torch.rwkv6_wkv)
def rwkv6_wkv_flop(r_shape, *args, **kwargs) -> int:
    B, S, H, hd = r_shape
    return 7 * B * S * H * hd * hd


def wkv(r, k, v, w, u, state=None, state_out=None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state, state_out: (B, H, hd,
    hd) or None -> (y, state_final)."""
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"wkv: no kernel for device {r.device}")
    if state_out is None:   # the kernel's f32; the plain version's dtype
        B, _, H, hd = r.shape
        state_out = torch.empty((B, H, hd, hd), dtype=torch.float32
                                if r.device.type == "cuda" else r.dtype,
                                device=r.device)
    return _wkv_op(r, k, v, w, u, state, state_out), state_out


def segmented_wkv(r, k, v, w, u, state=None, chunk: int = 64):
    """The WKV recurrence over ``chunk``-step segments, differentiable with
    respect to r, k, v, w, u and the state (the JAX package's checkpointed
    ``wkv_scan``).  Arguments as :func:`wkv`; returns (y, state_final),
    new tensors."""
    return segmented(wkv, rwkv6_wkv_ref, chunk, (r, k, v, w), (u,), state)


__all__ = ["rwkv6_wkv_flop", "segmented_wkv", "wkv"]
