"""Pure-python/numpy ChaCha20 oracle (RFC 8439 test-vector faithful)."""
from __future__ import annotations

import numpy as np

CONSTANTS = np.array([0x61707865, 0x3320646e, 0x79622d32, 0x6b206574],
                     np.uint32)


def _rotl(x, n):
    x = np.uint32(x)
    return np.uint32(((int(x) << n) | (int(x) >> (32 - n))) & 0xFFFFFFFF)


def _qr(s, a, b, c, d):
    s[a] = np.uint32((int(s[a]) + int(s[b])) & 0xFFFFFFFF)
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = np.uint32((int(s[c]) + int(s[d])) & 0xFFFFFFFF)
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = np.uint32((int(s[a]) + int(s[b])) & 0xFFFFFFFF)
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = np.uint32((int(s[c]) + int(s[d])) & 0xFFFFFFFF)
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha20_block_ref(key, nonce, counter):
    """key: (8,) u32; nonce: (3,) u32; counter: int -> (16,) u32 keystream."""
    state = np.concatenate([CONSTANTS, np.asarray(key, np.uint32),
                            np.array([counter], np.uint32),
                            np.asarray(nonce, np.uint32)])
    w = state.copy()
    for _ in range(10):
        _qr(w, 0, 4, 8, 12); _qr(w, 1, 5, 9, 13)   # noqa: E702
        _qr(w, 2, 6, 10, 14); _qr(w, 3, 7, 11, 15)  # noqa: E702
        _qr(w, 0, 5, 10, 15); _qr(w, 1, 6, 11, 12)  # noqa: E702
        _qr(w, 2, 7, 8, 13); _qr(w, 3, 4, 9, 14)    # noqa: E702
    return np.uint32((w.astype(np.uint64) + state.astype(np.uint64))
                     & 0xFFFFFFFF)


def chacha20_xor_ref(data, key, nonce, counter0=1):
    """data: (N, 16) u32 -> xored with per-block keystream."""
    out = np.empty_like(data)
    for i in range(data.shape[0]):
        out[i] = data[i] ^ chacha20_block_ref(key, nonce, counter0 + i)
    return out
