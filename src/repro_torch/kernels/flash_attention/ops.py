"""Flash attention on the model's layout, dispatched on the tensors' device.

``flash_attention(q, k, v)`` takes q (B, S, H, hd) and k, v (B, S, Kv, hd),
the layout ``models/attention.py`` makes, and returns (B, S, H, hd) (with
``return_lse=True`` also the rows' log-sum-exp, as training needs):
  - CUDA tensors launch the hand-written kernel (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch version (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, Kv, hd) -> (B, S, H, hd), and with
    ``return_lse`` also the rows' log-sum-exp (B, S, H) f32."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, return_lse)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, return_lse)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


__all__ = ["flash_attention"]
