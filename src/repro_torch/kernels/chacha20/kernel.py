"""ChaCha20 XOR over (N, 16) u32 blocks: the CUDA kernel and its plain
version (the VPC chain's stand-alone encryption NT).

The kernel (``csrc/chacha20.cu``) replaces the JAX package's Pallas kernel
``kernels/chacha20/kernel.py::chacha20_xor`` (body ``_chacha_kernel``).  It
runs one thread per 64-byte block with the 16 state words in registers.  On
an H100 it is bound by the INT32 issue rate (about 1,000 integer operations
per 128 bytes moved), not by memory; the design keeps everything in
registers and fully unrolls the rounds so the ALU work is all that is left.

:func:`chacha20_xor` dispatches on the tensor's device: a CUDA tensor
launches the kernel, a CPU tensor takes :func:`chacha20_xor_plain`, and
anything else raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch._u32 import MASK, arange32
from repro_torch.kernels import _build

from .core import xor_keystream

__all__ = ["chacha20_xor", "chacha20_xor_cuda", "chacha20_xor_plain"]


def chacha20_xor_plain(data, key, nonce, counter0: int = 1):
    """Plain PyTorch version: data XOR keystream, block ``i`` with counter
    ``counter0 + i`` (u32 wrap).  Runs on any device."""
    return xor_keystream(data, key, nonce,
                         arange32(counter0, data.shape[0], data.device))


def chacha20_xor_cuda(data, key, nonce, counter0: int = 1):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    data: (N, 16) u32, key: (8,) u32, nonce: (3,) u32, all contiguous on one
    CUDA device.  Counts its launches in ``chacha20_xor_cuda.launches``."""
    dev = data.device
    _build.require(data, "data", (-1, 16), dev, align=16)
    _build.require(key, "key", (8,), dev)
    _build.require(nonce, "nonce", (3,), dev)
    out = torch.empty_like(data)
    n = data.shape[0]
    if n == 0:
        return out
    lib = _build.library("chacha20")
    with torch.cuda.device(dev):
        err = lib.chacha20_xor_launch(
            data.data_ptr(), out.data_ptr(), key.data_ptr(), nonce.data_ptr(),
            int(counter0) & MASK, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "chacha20_xor")
    chacha20_xor_cuda.launches += 1
    return out


chacha20_xor_cuda.launches = 0


def chacha20_xor(data, key, nonce, *, counter0: int = 1):
    """data: (N, 16) u32 (N 64-byte blocks); key: (8,) u32; nonce: (3,) u32.

    Returns data XOR keystream — encryption and decryption are the same op.
    A CUDA tensor runs the kernel; a CPU tensor the plain version."""
    if data.device.type == "cuda":
        return chacha20_xor_cuda(data, key, nonce, counter0)
    if data.device.type == "cpu":
        return chacha20_xor_plain(data, key, nonce, counter0)
    raise ValueError(f"chacha20_xor: no kernel for device {data.device}")
