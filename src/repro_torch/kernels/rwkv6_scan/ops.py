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
"""
from __future__ import annotations

from repro_torch.kernels._segments import segmented

from .kernel import rwkv6_wkv_cuda
from .ref import rwkv6_wkv_ref


def wkv(r, k, v, w, u, state=None, state_out=None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state, state_out: (B, H, hd,
    hd) or None -> (y, state_final)."""
    if r.device.type == "cuda":
        return rwkv6_wkv_cuda(r, k, v, w, u, state, state_out)
    if r.device.type == "cpu":
        y, st = rwkv6_wkv_ref(r, k, v, w, u, state)
        if state_out is not None:
            st = state_out.copy_(st)
        return y, st
    raise ValueError(f"wkv: no kernel for device {r.device}")


def segmented_wkv(r, k, v, w, u, state=None, chunk: int = 64):
    """The WKV recurrence over ``chunk``-step segments, differentiable with
    respect to r, k, v, w, u and the state (the JAX package's checkpointed
    ``wkv_scan``).  Arguments as :func:`wkv`; returns (y, state_final),
    new tensors."""
    return segmented(wkv, rwkv6_wkv_ref, chunk, (r, k, v, w), (u,), state)


__all__ = ["segmented_wkv", "wkv"]
