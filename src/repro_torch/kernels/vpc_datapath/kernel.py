"""Fused VPC datapath: firewall -> NAT -> ChaCha20 -> egress in one launch.
The CUDA kernel and its plain fused version.

The kernel (``csrc/vpc_datapath.cu``) replaces the JAX package's Pallas
kernel ``kernels/vpc_datapath/kernel.py::vpc_datapath_kernel_call`` (body
``_vpc_datapath_kernel``).  One thread per packet: the longest-prefix match
over the rule table (staged into shared memory in chunks), the NAT rewrite
and the ChaCha20 keystream all stay in registers, and the egress verdict is
applied in the same pass, so each packet is read once and written once.  On
an H100 it is bound by the INT32 issue rate (about 5 integer operations per
rule and 1,000 for the keystream, against 173 bytes a packet), not by
memory; see the source for the design.

Inputs are preprocessed by :mod:`.ops`: per-packet counters ``ctr`` (N,) and
the rule table (R, 4) of ``{prefix, mask, mask length, allow}`` rows, all
u32.  :func:`vpc_datapath_fused` dispatches on the tensor's device: a CUDA
tensor launches the kernel, a CPU tensor takes :func:`vpc_datapath_plain`,
anything else raises.

Firewall tie-breaking: the reference resolves equal-length prefix hits with
``argmax`` (first index wins).  The kernel keeps the first strictly longer
hit while it walks the rules in order; the plain version keeps the Pallas
kernel's unique priority ``mlen * R + (R - 1 - idx)`` — the same winner by
construction, so the two check each other.
"""
from __future__ import annotations

import torch

from repro_torch._u32 import mul32, shl32, where32, widen
from repro_torch.kernels import _build
from repro_torch.kernels.chacha20.core import xor_keystream

__all__ = ["RULE_CHUNK", "vpc_datapath_cuda", "vpc_datapath_fused",
           "vpc_datapath_plain"]

#: rules staged into shared memory per pass (``kRuleChunk`` in the source)
RULE_CHUNK = 1024

#: the plain version takes packets in chunks so its (rows, R) priority
#: matrix stays near this many elements
_CHUNK_ELEMS = 1 << 24


def vpc_datapath_plain(headers, payload, ctr, rule_table, key, nonce, nat_ip,
                       salt: int):
    """Plain PyTorch version of the fused pass, on any device.  Returns
    (allow (N,) bool, headers (N, 5) u32, payload (N, 16) u32)."""
    dev = headers.device
    n, r = headers.shape[0], rule_table.shape[0]
    rt = widen(rule_table)
    prefixes, masks, rallow = rt[:, 0], rt[:, 1], rt[:, 3] != 0
    ridx = torch.arange(r, device=dev)
    rule_prio = rt[:, 2] * r + (r - 1 - ridx)
    allow = torch.empty(n, dtype=torch.bool, device=dev)
    hout = torch.empty_like(headers)
    pout = torch.empty_like(payload)
    step = max(1, _CHUNK_ELEMS // max(1, r))
    for i in range(0, n, step):
        s = slice(i, i + step)
        h = widen(headers[s])
        # ---- NT 1: firewall (longest-prefix match on dst, default allow)
        hit = (h[:, 1:2] & masks[None, :]) == prefixes[None, :]
        prio = torch.where(hit, rule_prio[None, :], -1)
        best = prio.max(dim=1, keepdim=True).values
        win_allow = (hit & (prio == best) & rallow[None, :]).any(dim=1)
        ok = torch.where(hit.any(dim=1), win_allow, True)
        # ---- NT 2: NAT source rewrite (flow-hash port, fixed ip)
        flow = h[:, 0] ^ mul32(h[:, 1], 2654435761) ^ shl32(h[:, 2], 16) \
            ^ h[:, 3] ^ h[:, 4]
        nat_h = h.clone()
        nat_h[:, 0] = widen(nat_ip.reshape(()))
        nat_h[:, 2] = (mul32(flow, salt) >> 16) & 0xFFFF
        # ---- NT 3 and egress: keystream XOR, verdict applied
        ct = xor_keystream(payload[s], key, nonce, widen(ctr[s]))
        allow[s] = ok
        hout[s] = where32(ok[:, None], nat_h, h)
        pout[s] = where32(ok[:, None], ct, 0)
    return allow, hout, pout


def vpc_datapath_cuda(headers, payload, ctr, rule_table, key, nonce, nat_ip,
                      salt: int):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    Every input contiguous u32 on one CUDA device: headers (N, 5), payload
    (N, 16), ctr (N,), rule_table (R, 4) with R >= 1, key (8,), nonce (3,),
    nat_ip (1,).  Counts its launches in ``vpc_datapath_cuda.launches``."""
    dev = headers.device
    n = headers.shape[0]
    _build.require(headers, "headers", (-1, 5), dev)
    _build.require(payload, "payload", (n, 16), dev, align=16)
    _build.require(ctr, "ctr", (n,), dev)
    _build.require(rule_table, "rule_table", (-1, 4), dev, align=16)
    _build.require(key, "key", (8,), dev)
    _build.require(nonce, "nonce", (3,), dev)
    _build.require(nat_ip, "nat_ip", (1,), dev)
    r = rule_table.shape[0]
    if r < 1:
        raise ValueError("vpc_datapath needs at least one firewall rule")
    allow = torch.empty(n, dtype=torch.bool, device=dev)
    hout = torch.empty_like(headers)
    pout = torch.empty_like(payload)
    if n == 0:
        return allow, hout, pout
    lib = _build.library("vpc_datapath")
    with torch.cuda.device(dev):
        err = lib.vpc_datapath_launch(
            headers.data_ptr(), payload.data_ptr(), ctr.data_ptr(),
            rule_table.data_ptr(), key.data_ptr(), nonce.data_ptr(),
            nat_ip.data_ptr(), int(salt) & 0xFFFFFFFF, allow.data_ptr(),
            hout.data_ptr(), pout.data_ptr(), n, r,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vpc_datapath")
    vpc_datapath_cuda.launches += 1
    return allow, hout, pout


vpc_datapath_cuda.launches = 0


def vpc_datapath_fused(headers, payload, ctr, rule_table, key, nonce, nat_ip,
                       salt: int):
    """The fused pass where the tensors lie: the CUDA kernel on the card,
    the plain version on the CPU."""
    if headers.device.type == "cuda":
        return vpc_datapath_cuda(headers, payload, ctr, rule_table, key,
                                 nonce, nat_ip, salt)
    if headers.device.type == "cpu":
        return vpc_datapath_plain(headers, payload, ctr, rule_table, key,
                                  nonce, nat_ip, salt)
    raise ValueError(f"vpc_datapath: no kernel for device {headers.device}")
