"""The grouped matmul, dispatched on the tensors' device, under autograd.

``grouped_matmul(x, w)`` takes x (E, M, d) and w (E, d, f) and returns
(E, M, f) in x's dtype:
  - CUDA tensors launch the hand-written kernel (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch version (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
Both go through :class:`GroupedMatmul`, whose backward is the cotangent of
the JAX package's ``einsum(x, w.astype(x.dtype))``, as ``torch.bmm``:
``dx = dy @ w.to(x.dtype)^T`` in x's dtype and ``dw = (x^T @ dy)`` cast to
w's dtype (an f32 master weight gets the product of its x-dtype copy cast
back).  The JAX package has no backward kernel; it differentiates XLA's
einsum, so the backward here is plain PyTorch on both devices.
"""
from __future__ import annotations

import torch

from .kernel import moe_gmm_cuda
from .ref import moe_gmm_ref


def _forward(x, w):
    if x.device.type == "cuda":
        return moe_gmm_cuda(x, w)
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w)
    raise ValueError(f"grouped_matmul: no kernel for device {x.device}")


class GroupedMatmul(torch.autograd.Function):
    """``out[e] = x[e] @ w[e]`` with the kernel (or, on the CPU, the plain
    version) forward and ``torch.bmm`` backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dy, w.to(x.dtype).transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(x.transpose(1, 2), dy).to(w.dtype)
        return dx, dw


def grouped_matmul(x, w):
    """x: (E, M, d); w: (E, d, f) -> (E, M, f) in x.dtype."""
    return GroupedMatmul.apply(x, w)


__all__ = ["GroupedMatmul", "grouped_matmul"]
