"""Shared ChaCha20 round arithmetic (RFC 8439) for the plain PyTorch paths.

The counterpart of the JAX package's ``kernels/chacha20/core.py``.  One
implementation of the add-rotate-xor double round feeds the plain versions
of both kernels and the composed chain:

  - :mod:`repro_torch.serving.vpc` — the composed path (``chacha20_xor``);
  - :mod:`repro_torch.kernels.chacha20.kernel` — the plain stand-alone NT;
  - :mod:`repro_torch.kernels.vpc_datapath.kernel` — the plain fused chain.

The CUDA kernels carry their own copy in ``csrc/chacha20.cuh``.  State is a
dict ``word-index -> int64 tensor`` of words in ``[0, 2**32)`` (see
:mod:`repro_torch._u32`), one element per ChaCha block.
"""
from __future__ import annotations

import torch

from repro_torch._u32 import MASK, add32, narrow, rotl32, widen

CONSTANTS = (0x61707865, 0x3320646e, 0x79622d32, 0x6b206574)

__all__ = ["CONSTANTS", "chacha_rounds", "init_state", "keystream",
           "quarter", "rotl32", "xor_keystream"]


def quarter(s, a, b, c, d):
    sa, sb, sc, sd = s[a], s[b], s[c], s[d]
    sa = add32(sa, sb)
    sd = rotl32(sd ^ sa, 16)
    sc = add32(sc, sd)
    sb = rotl32(sb ^ sc, 12)
    sa = add32(sa, sb)
    sd = rotl32(sd ^ sa, 8)
    sc = add32(sc, sd)
    sb = rotl32(sb ^ sc, 7)
    return {**s, a: sa, b: sb, c: sc, d: sd}


def chacha_rounds(state):
    """state: dict word-index -> int64 words. 20 rounds (10 double rounds)."""
    s = state
    for _ in range(10):
        # column rounds
        s = quarter(s, 0, 4, 8, 12)
        s = quarter(s, 1, 5, 9, 13)
        s = quarter(s, 2, 6, 10, 14)
        s = quarter(s, 3, 7, 11, 15)
        # diagonal rounds
        s = quarter(s, 0, 5, 10, 15)
        s = quarter(s, 1, 6, 11, 12)
        s = quarter(s, 2, 7, 8, 13)
        s = quarter(s, 3, 4, 9, 14)
    return s


def init_state(key_words, nonce_words, ctr):
    """Build the 16-word initial state.  ``key_words``: 8 words and
    ``nonce_words``: 3 words (ints or int64 scalars/tensors broadcastable
    to ``ctr``); ``ctr``: int64 tensor, one counter per block."""
    shape, dev = ctr.shape, ctr.device
    init = {w: torch.full(shape, CONSTANTS[w], dtype=torch.int64, device=dev)
            for w in range(4)}
    for w in range(8):
        init[4 + w] = torch.as_tensor(key_words[w], device=dev).to(
            torch.int64).expand(shape) & MASK
    init[12] = ctr & MASK
    for w in range(3):
        init[13 + w] = torch.as_tensor(nonce_words[w], device=dev).to(
            torch.int64).expand(shape) & MASK
    return init


def keystream(init):
    """Run the rounds and apply the final feed-forward add; returns the dict
    ``word-index -> int64 words`` of keystream words."""
    s = chacha_rounds(init)
    return {w: add32(s[w], init[w]) for w in range(16)}


def xor_keystream(data, key, nonce, ctr):
    """(N, 16) u32 ``data`` XOR the keystream of block counters ``ctr``
    (int64 words, one per block); ``key`` (8,) and ``nonce`` (3,) u32.
    Returns u32 on ``data``'s device."""
    dev = data.device
    k, nc = widen(key.to(dev)), widen(nonce.to(dev))
    ks = keystream(init_state([k[w] for w in range(8)],
                              [nc[w] for w in range(3)], ctr))
    return narrow(widen(data) ^ torch.stack([ks[w] for w in range(16)], 1))
