"""The grouped matmul, dispatched on the tensors' device.

``grouped_matmul(x, w)`` takes x (E, M, d) and w (E, d, f) and returns
(E, M, f) in x's dtype:
  - CUDA tensors launch the hand-written kernel (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch version (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from .kernel import moe_gmm_cuda
from .ref import moe_gmm_ref


def grouped_matmul(x, w):
    """x: (E, M, d); w: (E, d, f) -> (E, M, f) in x.dtype."""
    if x.device.type == "cuda":
        return moe_gmm_cuda(x, w)
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w)
    raise ValueError(f"grouped_matmul: no kernel for device {x.device}")


__all__ = ["grouped_matmul"]
