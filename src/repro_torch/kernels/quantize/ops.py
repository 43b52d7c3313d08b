"""Symmetric per-row int8 quantization, dispatched on the tensors' device.

``quantize(x)`` returns (q (R, D) int8, scale (R, 1) f32) and
``dequantize(q, scale, dtype=torch.float32)`` returns (R, D) ``dtype``:
  - CUDA tensors launch the hand-written kernels (:mod:`.kernel`);
  - CPU tensors take the plain PyTorch versions (:mod:`.ref`);
  - anything else raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .kernel import dequantize_int8_cuda, quantize_int8_cuda
from .ref import dequantize_int8_ref, quantize_int8_ref


def quantize(x):
    """x: (R, D) f32 or bf16 -> (q (R, D) int8, scale (R, 1) f32)."""
    if x.device.type == "cuda":
        return quantize_int8_cuda(x)
    if x.device.type == "cpu":
        return quantize_int8_ref(x)
    raise ValueError(f"quantize: no kernel for device {x.device}")


def dequantize(q, scale, dtype=torch.float32):
    """(q (R, D) int8, scale (R, 1) f32) -> (R, D) ``dtype``."""
    if q.device.type == "cuda":
        return dequantize_int8_cuda(q, scale, dtype)
    if q.device.type == "cpu":
        return dequantize_int8_ref(q, scale, dtype)
    raise ValueError(f"dequantize: no kernel for device {q.device}")


__all__ = ["dequantize", "quantize"]
