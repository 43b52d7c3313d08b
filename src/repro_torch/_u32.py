"""Wrapping 32-bit unsigned arithmetic for the plain PyTorch paths.

Packet fields travel as ``torch.uint32`` tensors, but PyTorch implements
few operators for that type: on the CPU ``+``, ``<<``, ``>>`` and ``max``
raise ``NotImplementedError``, and on CUDA so do ``^``, ``&``, ``*``,
``where`` and indexing (PyTorch 2.11).  Allocation, copies, conversions,
``cat``, slicing, ``==`` and ``torch.equal`` work on both.  The plain
versions of the kernels therefore widen every word to ``int64``, compute,
and mask back to 32 bits.  Every helper here takes and
returns int64 tensors that hold values in ``[0, 2**32)``; ``widen`` and
``narrow`` convert at the edges.  The CUDA kernels use native
``uint32_t`` and need none of this.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """u32 (or any integer / bool) tensor -> int64 words in [0, 2**32)."""
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 words -> ``torch.uint32`` (low 32 bits)."""
    return (x & MASK).to(torch.uint32)


def add32(a, b):
    return (a + b) & MASK


def mul32(a, b):
    """Low 32 bits of ``a * b``.  The full product of two u32 values can
    pass 2**63, so ``b`` is split into 16-bit halves: each partial product
    stays below 2**48 and nothing relies on int64 overflow."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


def shl32(x, n: int):
    return (x << n) & MASK


def rotl32(x, n: int):
    return ((x << n) & MASK) | (x >> (32 - n))


def popcount32(x):
    """Set bits per word (SWAR); the last multiply stays below 2**57."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def where32(cond, a, b):
    """``torch.where`` for u32 tensors (or an int ``b``), on any device."""
    b = widen(b) if isinstance(b, torch.Tensor) else b
    return narrow(torch.where(cond, widen(a), b))


def arange32(start, n: int, device=None) -> torch.Tensor:
    """``start + arange(n)`` with u32 wrap, as int64 words.  ``start`` is an
    int or a 0-d/1-element integer tensor (a counter base that lives on the
    device stays there: no host sync).  ``device=None`` is the tensor
    ``start``'s device, else PyTorch's default device."""
    if isinstance(start, torch.Tensor):
        device = start.device if device is None else device
        start = widen(start.reshape(()).to(device))
    else:
        start = int(start) & MASK
    return (torch.arange(n, dtype=torch.int64, device=device) + start) & MASK


__all__ = ["MASK", "add32", "arange32", "mul32", "narrow", "popcount32",
           "rotl32", "shl32", "where32", "widen"]
