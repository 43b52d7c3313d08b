"""Flash attention on the model's layout, dispatched on the tensors' device.

``flash_attention(q, k, v)`` takes q (B, S, H, hd) and k, v (B, S, Kv, hd),
the layout ``models/attention.py`` makes, and returns (B, S, H, hd) (with
``return_lse=True`` also the rows' log-sum-exp, as training needs):
  - CUDA tensors launch the hand-written kernel (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch version (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
Both go through one ``torch.library`` op, ``repro_torch::flash_attention``,
so a fake-tensor trace (the dry run, ``launch/dryrun.py``) sees one op a
launch, with its output shapes and the kernel's own FLOP (the causal
triangle: 4 B H hd S (S + 1) / 2).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import flash_attention_cuda
from .ref import attention_ref


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, return_lse: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cuda":
        got = flash_attention_cuda(q, k, v, causal, return_lse)
    else:
        got = attention_ref(q, k, v, causal, return_lse)
    if return_lse:
        return got
    return got, q.new_empty((0,), dtype=torch.float32)


@_flash_op.register_fake
def _(q, k, v, causal, return_lse):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (B, S, H) if return_lse else (0,), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flop(q_shape, k_shape, v_shape, causal, *args,
                         **kwargs) -> int:
    """QK^T and PV over the (causal) score entries: 4 B H hd per entry."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * (S * (S + 1) // 2 if causal else S * S)


def flash_attention(q, k, v, causal: bool = True, return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, Kv, hd) -> (B, S, H, hd), and with
    ``return_lse`` also the rows' log-sum-exp (B, S, H) f32."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out, lse = _flash_op(q, k, v, causal, return_lse)
    return (out, lse) if return_lse else out


__all__ = ["flash_attention", "flash_attention_flop"]
