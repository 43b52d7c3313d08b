"""Virtual Private Cloud NT chain (paper §6.2, Figure 11):
firewall -> NAT -> encryption, as plain batched PyTorch.

The counterpart of the JAX package's ``serving/vpc.py``.  These are the
composed NT ops of the compute backend and the oracle the fused kernel is
held to.  Packet fields are ``torch.uint32`` tensors; the arithmetic runs
on int64-widened words (:mod:`repro_torch._u32`), so every result is
bit-identical with the JAX package.

  - firewall: longest-prefix-match against a rule table (allow/deny);
  - NAT: source ip/port rewrite from a flow hash;
  - encrypt: ChaCha20 keystream XOR over payload blocks (see
    :mod:`repro_torch.kernels.chacha20`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch._u32 import (MASK, arange32, mul32, narrow, popcount32,
                              shl32, where32, widen)
from repro_torch.kernels.chacha20.core import xor_keystream

#: the plain firewall materialises an (rows, R) int64 score matrix; rows are
#: taken in chunks so that matrix stays near this many elements
_FW_CHUNK_ELEMS = 1 << 24


# =============================================================== firewall ====
def make_rules(n_rules: int = 32, seed: int = 0, device=None):
    """Random prefix rules: (prefix, mask, allow) tensors on ``device``.
    Drawn with numpy exactly as the JAX package draws them."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(0, 2 ** 32, n_rules, dtype=np.uint32)
    mask_len = rng.integers(8, 25, n_rules)
    allow = rng.random(n_rules) < 0.5
    masks = (~np.uint32(0)) << np.uint32(32 - mask_len)
    return (torch.from_numpy(prefixes & masks).to(dev),
            torch.from_numpy(masks).to(dev), torch.from_numpy(allow).to(dev))


def firewall(headers, rules):
    """headers: (N, 5) uint32 [src, dst, sport, dport, proto].

    Longest-prefix-match on dst; default allow. Returns (N,) bool."""
    prefixes, masks, allow = rules
    pre, msk = widen(prefixes), widen(masks)
    # longest mask wins: score = mask popcount where hit else -1 (the score
    # stays signed int64, so the -1 sentinel never outranks a real hit);
    # argmax returns the first maximal index, the reference's tie-break
    mlen = popcount32(msk)[None, :]
    dst = widen(headers[:, 1])
    n = dst.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=dst.device)
    step = max(1, _FW_CHUNK_ELEMS // max(1, pre.shape[0]))
    for i in range(0, n, step):
        hit = (dst[i:i + step, None] & msk[None, :]) == pre[None, :]
        score = torch.where(hit, mlen, -1)
        best = torch.argmax(score, dim=1)
        out[i:i + step] = torch.where(hit.any(dim=1), allow[best], True)
    return out


# ==================================================================== NAT ====
def _word(v, device) -> torch.Tensor:
    """An int or a 1-element integer tensor -> 0-d int64 word on device."""
    if isinstance(v, torch.Tensor):
        return widen(v.reshape(()).to(device))
    return torch.tensor(int(v) & MASK, dtype=torch.int64, device=device)


def nat_rewrite(headers, nat_ip, salt: int = 0x9e3779b9):
    """Source NAT: rewrite (src ip, src port) -> (nat_ip, hash(flow)).

    The flow hash is a Fibonacci-style integer mix — a deterministic stand-in
    for the sNIC's flow-table lookup, fully vectorized."""
    h = widen(headers)
    flow = h[:, 0] ^ mul32(h[:, 1], 2654435761) ^ shl32(h[:, 2], 16) \
        ^ h[:, 3] ^ h[:, 4]
    new_port = (mul32(flow, salt) >> 16) & 0xFFFF
    out = h.clone()
    out[:, 0] = _word(nat_ip, h.device)
    out[:, 2] = new_port
    return narrow(out)


# ================================================================ encrypt ====
def chacha20_xor(data, key, nonce, counter0=1, ctr=None):
    """ChaCha20 over (N, 16) u32 blocks, as plain PyTorch (the counterpart
    of the JAX package's ``chacha20_xor_jnp``; the CUDA kernels in
    :mod:`repro_torch.kernels` are the fast versions of this NT).

    ``ctr`` optionally gives each block an explicit u32 counter (shape (N,)).
    The default is ``counter0 + arange(N)`` with u32 wrap — making the
    counter part of the packet state lets the runtime coalesce batches
    without changing any packet's keystream."""
    dev = data.device
    ctr = arange32(counter0, data.shape[0], dev) if ctr is None \
        else widen(ctr.to(dev))
    return xor_keystream(data, key, nonce, ctr)


# ================================================================= chain ====
def vpc_chain(headers, payload, rules, key, nonce, nat_ip=0x0A000001,
              counter0=1):
    """The full firewall -> NAT -> encrypt chain on a packet batch.

    headers: (N, 5) u32; payload: (N, 16) u32 (one 64-byte block/packet).
    Returns (allow_mask, new_headers, ciphertext)."""
    allow = firewall(headers, rules)
    newh = nat_rewrite(headers, nat_ip)
    ct = chacha20_xor(payload, key, nonce, counter0)
    # denied packets keep original header and payload zeroed
    newh = where32(allow[:, None], newh, headers)
    ct = where32(allow[:, None], ct, 0)
    return allow, newh, ct


def make_packets(n: int, seed: int = 0, device=None):
    """Random (headers (n, 5), payload (n, 16)) u32 tensors on ``device``,
    drawn with numpy exactly as the JAX package draws them."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    headers = rng.integers(0, 2 ** 32, (n, 5), dtype=np.uint32)
    payload = rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint32)
    return torch.from_numpy(headers).to(dev), torch.from_numpy(payload).to(dev)


__all__ = ["chacha20_xor", "firewall", "make_packets", "make_rules",
           "nat_rewrite", "vpc_chain"]
