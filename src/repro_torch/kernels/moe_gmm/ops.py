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
einsum, so the backward here is plain PyTorch on both devices.  The
forward is one ``torch.library`` op, ``repro_torch::moe_gmm``, so a
fake-tensor trace (the dry run) sees one op a launch and its 2 E M d f
FLOP.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import moe_gmm_cuda
from .ref import moe_gmm_ref


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _gmm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return moe_gmm_cuda(x, w)
    return moe_gmm_ref(x, w)


@_gmm_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.moe_gmm)
def moe_gmm_flop(x_shape, w_shape, *args, **kwargs) -> int:
    E, M, d = x_shape
    return 2 * E * M * d * w_shape[2]


def _forward(x, w):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"grouped_matmul: no kernel for device {x.device}")
    return _gmm_op(x, w)


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


__all__ = ["GroupedMatmul", "grouped_matmul", "moe_gmm_flop"]
