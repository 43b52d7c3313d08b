"""Encrypt/decrypt byte payloads with ChaCha20."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device

from .kernel import chacha20_xor


def encrypt(data_u32, key, nonce, counter0: int = 1):
    """data_u32: (N, 16) u32. Encryption == decryption (stream cipher).
    Runs where ``data_u32`` lies: the CUDA kernel on the card, the plain
    version on the CPU."""
    return chacha20_xor(data_u32, key, nonce, counter0=counter0)


def smem_tile_bytes() -> int:
    """Shared memory one block of the CUDA kernel uses: none (each thread
    keeps its block's state in registers).  Takes the place of the JAX
    package's ``vmem_tile_bytes`` in the admission verifier's budget."""
    return 0


# The two byte<->block converters below are *ingress/egress boundary*
# conversions: they run once per payload at the host edge, never inside a
# dispatch loop.

def bytes_to_blocks(raw: bytes, device=None):
    """Pad bytes to 64-byte blocks -> ((N, 16) u32 little-endian tensor on
    ``device``, byte count)."""
    pad = (-len(raw)) % 64
    buf = np.frombuffer(raw + b"\0" * pad, np.uint8)
    blocks = torch.from_numpy(buf.view(np.uint32).reshape(-1, 16).copy())
    return blocks.to(_device.resolve(device)), len(raw)


def blocks_to_bytes(blocks, n_bytes: int) -> bytes:
    return blocks.cpu().numpy().view(np.uint8).tobytes()[:n_bytes]


__all__ = ["blocks_to_bytes", "bytes_to_blocks", "encrypt", "smem_tile_bytes"]
