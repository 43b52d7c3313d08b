"""Reference for the fused VPC datapath: the same plain building blocks as
:func:`repro_torch.serving.vpc.vpc_chain`, composed in one function.

``vpc_datapath_ref`` equals ``vpc_chain`` for ``ctr=None`` (it calls the
same firewall / nat_rewrite / chacha20_xor code), and the CUDA kernel and
its plain fused version must equal this ref for any explicit per-packet
counter.
"""
from __future__ import annotations

from repro_torch._u32 import where32
from repro_torch.serving.vpc import chacha20_xor, firewall, nat_rewrite


def vpc_datapath_ref(headers, payload, rules, key, nonce,
                     nat_ip=0x0A000001, counter0=1, ctr=None):
    """headers: (N, 5) u32; payload: (N, 16) u32; rules: (prefixes, masks,
    allow).  Returns (allow_mask, new_headers, ciphertext) — the same triple
    and bits as ``vpc_chain``."""
    allow = firewall(headers, rules)
    newh = nat_rewrite(headers, nat_ip)
    ct = chacha20_xor(payload, key, nonce, counter0, ctr=ctr)
    # denied packets keep original header and payload zeroed
    newh = where32(allow[:, None], newh, headers)
    ct = where32(allow[:, None], ct, 0)
    return allow, newh, ct
