"""Wrapper for the fused VPC datapath.

Handles what the raw kernel takes preprocessed: the rule table (mask
popcounts, bool -> u32), default per-packet counters, and the u32 scalars.
No padding is needed: the kernel masks the ragged edge itself.  The result
triple matches ``vpc_chain`` bit-for-bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._u32 import arange32, narrow, popcount32, widen

from .kernel import SMEM_BYTES, vpc_datapath_fused


def smem_tile_bytes() -> int:
    """Shared memory one block of the CUDA kernel holds: the staged rule
    chunk and the tile's header rows, counters and allowed list
    (``kernel.SMEM_BYTES``).  The admission verifier sums this per fused
    branch against ``core.vmem.VMEM_BUDGET_BYTES``."""
    return SMEM_BYTES


def rule_table(rules, device) -> torch.Tensor:
    """(prefixes, masks, allow) -> contiguous (R, 4) u32 rows of
    ``{prefix, mask, mask length, allow}`` on ``device``."""
    # three rule arrays, once a deployment and device (the fused program's
    # cache in api/compute_backend.py)
    prefixes, masks, allow = (widen(x.to(device))  # noqa: L-RING
                              for x in rules)
    return narrow(torch.stack([prefixes, masks, popcount32(masks),
                               (allow != 0).to(torch.int64)], 1)).contiguous()


def _u32(x, device) -> torch.Tensor:
    """A u32 word or array as a contiguous 1-d ``torch.uint32`` tensor on
    ``device`` (an int becomes one element)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.uint32).reshape(-1))
    if x.dtype != torch.uint32:
        x = narrow(x.to(torch.int64))
    return x.to(device).reshape(-1).contiguous()


def datapath_args(rules, key, nonce, nat_ip, device) -> dict:
    """The inputs of the kernel that do not change from batch to batch,
    built on ``device``: the (R, 4) rule table and the key, nonce and NAT
    address as u32.  A deployment builds them once per device and hands
    them to :func:`vpc_datapath_prepared` on every dispatch."""
    return {"rule_table": rule_table(rules, device),
            "key": _u32(key, device), "nonce": _u32(nonce, device),
            "nat_ip": _u32(nat_ip, device)}


def vpc_datapath_prepared(headers, payload, args: dict, counter0=1,
                          ctr=None, salt: int = 0x9e3779b9):
    """:func:`vpc_datapath` over inputs :func:`datapath_args` built on the
    packets' device."""
    n = headers.shape[0]
    dev = headers.device
    if n == 0:                  # empty batch: nothing to launch
        return (torch.zeros((0,), dtype=torch.bool, device=dev), headers,
                payload)
    if ctr is None:
        ctr = narrow(arange32(counter0, n, dev))
    return vpc_datapath_fused(
        headers.contiguous(), payload.contiguous(), _u32(ctr, dev),
        args["rule_table"], args["key"], args["nonce"], args["nat_ip"], salt)


def vpc_datapath(headers, payload, rules, key, nonce, nat_ip=0x0A000001,
                 counter0=1, ctr=None, salt: int = 0x9e3779b9):
    """Fused firewall -> NAT -> ChaCha20 over a packet batch, one kernel
    launch on the card (the plain fused version for CPU tensors).  Same
    signature contract as ``vpc_chain``: headers (N, 5) u32, payload (N, 16)
    u32 -> (allow (N,) bool, new_headers, ciphertext).

    ``ctr``: optional (N,) u32 per-packet keystream counters (defaults to
    ``counter0 + arange(N)`` with u32 wrap, the ``vpc_chain`` convention).
    ``nat_ip`` and ``counter0`` may be ints or 1-element tensors on the
    device; a tensor ``counter0`` is expanded on the device, never read
    back to the host."""
    return vpc_datapath_prepared(
        headers, payload,
        datapath_args(rules, key, nonce, nat_ip, headers.device),
        counter0=counter0, ctr=ctr, salt=salt)


__all__ = ["datapath_args", "rule_table", "smem_tile_bytes", "vpc_datapath",
           "vpc_datapath_prepared"]
