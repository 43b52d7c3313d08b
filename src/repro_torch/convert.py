"""Parameters carried across from the JAX package.

:func:`params_from_numpy` turns a ``ComputeBackend`` deploy-params dict
whose leaves are numpy arrays (``np.asarray`` of the JAX arrays, or arrays
made with numpy) into the port's dict: firewall ``rules`` (prefixes, masks,
allow), the ChaCha20 ``key`` and ``nonce`` and the NAT ``nat_ip`` become
``torch.uint32`` / ``torch.bool`` tensors on one device.  Every other entry
(``counter0``, stream flags) is kept as it is.  Both packages then compute
the same thing from the same parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device

#: per-NT parameter entries that hold u32 words (or a bool rule mask)
_TENSOR_KEYS = ("key", "nonce", "nat_ip")


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype != np.bool_:
        a = a.astype(np.uint32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(params: dict, device=None) -> dict:
    """``{nt_name: {param: value}}`` with numpy (or int) leaves -> the same
    dict with tensor leaves on ``device`` (default ``cuda:0``)."""
    dev = _device.resolve(device)
    out = {}
    for name, p in params.items():
        q = dict(p)
        if "rules" in q:
            q["rules"] = tuple(_tensor(x, dev) for x in q["rules"])
        for k in _TENSOR_KEYS:
            if k in q:
                q[k] = _tensor(q[k], dev)
        out[name] = q
    return out


__all__ = ["params_from_numpy"]
