"""Plain PyTorch version of symmetric per-row int8 quantization.

The counterpart of the JAX package's ``kernels/quantize/ref.py`` (and of
``optim/compress.py``'s ``quant_int8`` / ``dequant_int8``), in the same
order of operations: ``scale = max(max|x|, 1e-12) / 127`` with an IEEE f32
division, then ``clamp(round_half_even(x / scale), -127, 127)``.  Bit for
bit equal to both on the same inputs.  The CPU path of :mod:`.ops`, the
tests' oracle, and what ``chip_smoke.py`` holds the CUDA kernels against on
the card.  Runs on any device.
"""
from __future__ import annotations

import torch


def quantize_int8_ref(x):
    """x (R, D) float -> (q (R, D) int8, scale (R, 1) f32).  A row of D = 0
    has the scale of an all-zero row, as the JAX package's max gives."""
    xf = x.float()
    if xf.shape[1] == 0:
        amax = torch.zeros((xf.shape[0], 1), dtype=torch.float32,
                           device=x.device)
    else:
        amax = xf.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient in every row
    scale = amax.clamp(min=1e-12) / torch.full_like(amax, 127.0)
    # in place after the quotient: one f32 temporary of x's size
    q = torch.div(xf, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q, scale, dtype=torch.float32):
    """(q (R, D) int8, scale (R, 1) f32) -> (R, D) ``dtype``."""
    return q.float().mul_(scale).to(dtype)


__all__ = ["dequantize_int8_ref", "quantize_int8_ref"]
