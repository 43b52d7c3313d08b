"""Parameters carried across from the JAX package.

:func:`params_from_numpy` turns a ``ComputeBackend`` deploy-params dict
whose leaves are numpy arrays (``np.asarray`` of the JAX arrays, or arrays
made with numpy) into the port's dict: firewall ``rules`` (prefixes, masks,
allow), the ChaCha20 ``key`` and ``nonce`` and the NAT ``nat_ip`` become
``torch.uint32`` / ``torch.bool`` tensors on one device.  Every other entry
(``counter0``, stream flags) is kept as it is.  Both packages then compute
the same thing from the same parameters.

:func:`model_params_from_numpy` does the same for a model: the JAX
package's parameter pytree with numpy leaves (``jax.tree.map(np.asarray,
params)``) becomes the port's dict of tensors, with the layers as a list
whether the JAX package stacked them for ``lax.scan`` or not (a
homogeneous MoE stack such as Granite's is stacked, Jamba's hybrid stack
is a list; ``moe`` and ``mamba`` leaves carry across like any other).
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


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy kind
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _leaf(tree, device)


def _unstack(layers: dict, n: int) -> list:
    """A pytree of leaves stacked along axis 0 -> a list of n pytrees."""
    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        a = np.asarray(t)
        if a.shape[:1] != (n,):
            raise ValueError(f"stacked layer leaf of shape {a.shape} does "
                             f"not lead with n_layers = {n}")
        return a[i]
    return [pick(layers, i) for i in range(n)]


def model_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The JAX package's model parameters with numpy leaves -> the port's
    dict of tensors on ``device`` (default ``cuda:0``), dtypes kept.
    ``tree["layers"]`` may be a list of per-layer dicts (``scan_layers``
    off) or one dict whose leaves are stacked along axis 0."""
    dev = _device.resolve(device)
    tree = dict(tree)
    layers = tree["layers"]
    if isinstance(layers, dict):
        layers = _unstack(layers, cfg.n_layers)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a config with "
                         f"n_layers = {cfg.n_layers}")
    tree["layers"] = list(layers)
    return _tree(tree, dev)


__all__ = ["model_params_from_numpy", "params_from_numpy"]
