"""Sharding rules: parameter / optimizer / batch / cache specs, the JAX
package's ``parallel/sharding.py`` over ``torch.distributed`` meshes.

Mesh axes (see :mod:`repro_torch.launch.mesh`):
  - single pod : ("data", "model") = (16, 16)
  - multi-pod  : ("pod", "data", "model") = (2, 16, 16)

Baseline policy, as in the JAX package:
  - parameters: tensor-parallel over "model" on the contraction-friendly dim
    (heads / d_ff / d_inner / vocab), FSDP over the data axes on the other
    matrix dim; vectors and norms replicated;
  - optimizer moments: same spec as their parameter;
  - batch: sharded over all data axes;
  - KV / SSM caches (decode): batch over data axes when divisible, sequence
    over "model", state dims over "model" for SSM/RWKV.

A spec is a :class:`P`: per tensor dim an axis name, a tuple of axis names
(major to minor, in the mesh's order) or ``None``.  A mesh is anything with
``.shape`` (a dict of axis sizes) and ``.axis_names``, or a
``torch.distributed`` ``DeviceMesh`` (read through :func:`view`), so one
stand-in mesh drives both packages' rule tables in the tests.  Differences
from the JAX package:
  - the port's layers are always a list, the JAX package's unstacked
    (``stacked = False``) branch, in :func:`param_specs` and
    :func:`cache_specs` alike;
  - :func:`to_placements` stands in for ``NamedSharding``: an axis tuple on
    tensor dim ``d`` becomes ``Shard(d)`` on each of those mesh dims.
    DTensor splits over mesh dims left to right, so each rank gets the
    chunk JAX's major-to-minor order gives it; a tuple out of the mesh's
    order has no DTensor counterpart and raises.
"""
from __future__ import annotations

from typing import Any

import numpy as np

TP = "model"


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("data", "model"))``."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class MeshView:
    """A ``DeviceMesh`` seen as the rule tables see a mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = {n: int(mesh.size(i))
                      for i, n in enumerate(self.axis_names)}


def view(mesh):
    """``mesh`` with ``.shape`` (dict) and ``.axis_names``."""
    if hasattr(mesh, "mesh_dim_names"):
        return MeshView(mesh)
    return mesh


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in view(mesh).axis_names if a != TP)


def fit_spec(spec, shape, mesh) -> P:
    """Drop axis assignments that do not divide the dim evenly."""
    mesh = view(mesh)
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([mesh.shape[a] for a in axes]))
        out.append(ax if dim % n == 0 else None)
    return P(*out)


def _path_str(path) -> str:
    return "/".join(str(e) for e in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (NamedTuples
    too); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        kids = [_map_with_path(fn, v, path + (i,)) for i, v in
                enumerate(tree)]
        if isinstance(tree, list):
            return kids
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(path, tree)


def _leaves(tree) -> list:
    out: list = []
    _map_with_path(lambda _, x: out.append(x), tree)
    return out


def _param_spec(path: str, ndim: int, fsdp, moe_ep: bool = False) -> P:
    """Spec for one parameter of ``ndim`` dims."""
    f = fsdp  # tuple of data axes or None

    def pick(*spec):
        return P(*spec)

    # ---- embeddings / head ----
    if path.endswith("embed/table"):
        return pick(TP, None)               # vocab-sharded rows
    if path.endswith("head/w"):
        return pick(f, TP)                  # column-parallel logits
    # ---- norms, scalars, small vectors ----
    if "norm" in path or "/ln_" in path or path.endswith("/g") \
            or path.endswith("mu_x") or path.endswith("/mu") \
            or path.endswith("mu_k") or path.endswith("mu_r") \
            or path.endswith("w0") or path.endswith("/u"):
        return P()
    # ---- attention ----
    if "/attn/" in path:
        if path.endswith("wo/w"):
            return pick(TP, f)              # row-parallel out-proj
        if path.endswith("/w"):
            return pick(f, TP)              # wq/wk/wv column-parallel
        if path.endswith("/b"):
            return pick(TP)                 # qkv bias follows columns
        return P()
    # ---- MoE ----
    if "/moe/" in path:
        if "router" in path:
            return P()
        if moe_ep:                          # expert-parallel: E over "model"
            if path.endswith("down"):
                return pick(TP, None, f)    # (E, dff, d)
            return pick(TP, f, None)        # gate/up (E, d, dff)
        if path.endswith("down"):
            return pick(None, TP, f)        # (E, dff, d)
        return pick(None, f, TP)            # gate/up (E, d, dff)
    # ---- MLP ----
    if "/mlp/" in path:
        if path.endswith("down/w"):
            return pick(TP, f)
        if path.endswith("/w"):
            return pick(f, TP)
        return pick(TP) if ndim == 1 else P()
    # ---- Mamba ----
    if "/mamba/" in path:
        if path.endswith("in_proj/w"):
            return pick(f, TP)
        if path.endswith("out_proj/w"):
            return pick(TP, f)
        if path.endswith("conv_w"):
            return pick(None, TP)
        if path.endswith("conv_b") or path.endswith("dt_bias") \
                or path.endswith("D"):
            return pick(TP)
        if path.endswith("x_proj/w"):
            return pick(TP, None)           # row-parallel, small output
        if path.endswith("dt_proj/w"):
            return pick(None, TP)
        if path.endswith("A_log"):
            return pick(TP, None)
        return P()
    # ---- RWKV ----
    if "/rwkv_tm/" in path or "/rwkv_cm/" in path:
        if path.endswith("wo/w") or path.endswith("wv/w") and "/rwkv_cm/" in path:
            return pick(TP, f)
        if path.endswith("/w"):
            # wr/wk/wv/wg (d,d) col-parallel; cm wk (d,dff) col-parallel
            return pick(f, TP)
        return P()                          # loras, mus, gains
    # in_norm (embeds frontend) and anything else small
    return P()


def param_specs(params: Any, mesh, fsdp_over_pod: bool = True,
                mode: str = "train", fsdp_only: bool = False,
                moe_ep: bool = False) -> Any:
    """Spec tree matching ``params`` (tensors, fake or meta tensors: only
    shapes are read).

    mode="train": FSDP over the data axes + TP over "model" (default), or,
    with ``fsdp_only``, FSDP over *all* axes and no TP.
    mode="serve": TP only (weights stay resident), FSDP x TP for a model
    whose TP shard exceeds 10 GB of bf16; ``fsdp_only`` prefill
    replicates every weight.
    """
    mesh = view(mesh)
    d_ax = data_axes(mesh)
    if mode == "prefill" and fsdp_only:
        return _map_with_path(lambda _, leaf: P(*((None,) * leaf.ndim)),
                              params)
    if mode in ("serve", "prefill", "decode"):
        tp_size = int(mesh.shape.get(TP, 1))
        bytes_per_dev = sum(int(np.prod(x.shape)) * 2
                            for x in _leaves(params)) / tp_size
        if bytes_per_dev <= 10e9:
            fsdp = None
        else:
            fsdp = d_ax if len(d_ax) > 1 else (d_ax[-1] if d_ax else None)
    elif fsdp_only:
        fsdp = tuple(d_ax) + (TP,)
    else:
        fsdp = d_ax if (fsdp_over_pod and len(d_ax) > 1) else \
            (d_ax[-1] if d_ax else None)
    drop_tp = (mode == "train" and fsdp_only)

    def one(path, leaf):
        spec = _param_spec(_path_str(path), leaf.ndim, fsdp, moe_ep)
        if drop_tp:  # no tensor parallelism: TP appears only inside `fsdp`
            spec = P(*(None if ax == TP else ax for ax in tuple(spec)))
        return fit_spec(spec, leaf.shape, mesh)

    return _map_with_path(one, params)


def batch_specs(batch: Any, mesh, all_axes: bool = False,
                seq_over_model: bool = False) -> Any:
    """Tokens/labels (B, S) or embeds (B, S, d): batch over the data axes,
    or over *every* axis for fsdp_only training; ``seq_over_model`` also
    shards the sequence dim over "model"."""
    mesh = view(mesh)
    if all_axes:
        dp = tuple(mesh.axis_names)
    else:
        d_ax = data_axes(mesh)
        dp = d_ax if len(d_ax) > 1 else d_ax[0]
    seq = TP if (seq_over_model and not all_axes) else None

    def one(path, leaf):
        nd = leaf.ndim
        p = _path_str(path)
        if p.endswith("positions") and nd == 3:    # (3, B, S) M-RoPE
            spec = P(None, dp, seq)
        elif nd >= 2:
            spec = P(*((dp, seq) + (None,) * (nd - 2)))
        else:
            spec = P(dp)
        return fit_spec(spec, leaf.shape, mesh)

    return _map_with_path(one, batch)


def cache_specs(cfg, cache: Any, mesh, B: int) -> Any:
    """Decode-state sharding of the per-layer cache list.  Attention KV (B,
    S, Kv, hd): batch over data axes (if divisible) and sequence over
    "model"; if batch is too small, sequence over every axis.  SSM/RWKV
    states: feature dims over "model", batch over data axes when
    divisible."""
    mesh = view(mesh)
    d_ax = data_axes(mesh)
    dsize = int(np.prod([mesh.shape[a] for a in d_ax]))
    dp = d_ax if len(d_ax) > 1 else d_ax[0]
    batch_ok = B % dsize == 0 and B >= dsize

    def one(path, leaf):
        p = _path_str(path)
        if p.endswith("/k") or p.endswith("/v") or p == "k" or p == "v":
            if batch_ok:
                spec = (dp, TP, None, None)          # (B, S, Kv, hd)
            else:
                spec = (None, tuple(d_ax) + (TP,), None, None)
        elif "ssm" in p:                             # (B, di, ds)
            spec = ((dp if batch_ok else None), TP, None)
        elif "conv" in p:                            # (B, dc-1, di)
            spec = ((dp if batch_ok else None), None, TP)
        elif "wkv" in p:                             # (B, H, hd, hd)
            spec = ((dp if batch_ok else None), TP, None, None)
        elif p.endswith("x_tm") or p.endswith("x_cm"):  # (B, d)
            spec = ((dp if batch_ok else None), None)
        else:
            spec = (None,) * leaf.ndim
        return fit_spec(spec, leaf.shape, mesh)

    return _map_with_path(one, cache)


# ------------------------------------------------------ DTensor placement --
def to_placements(spec, mesh) -> list:
    """The DTensor placements (one per mesh dim) of ``spec`` on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = view(mesh).axis_names
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(tuple(spec)):
        if ax is None:
            continue
        dims = [names.index(a) for a in (ax if isinstance(ax, tuple)
                                         else (ax,))]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {ax} are not in the mesh's "
                             f"order {names}")
        for i in dims:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return out


def to_shardings(spec_tree: Any, mesh) -> Any:
    """A tree of placement lists for a tree of specs."""
    return _map_with_path(lambda _, s: to_placements(s, mesh), spec_tree)


def place(x, mesh, placements):
    """The full value ``x`` (the same on every rank) as a DTensor: each rank
    keeps its own chunk, in storage of its own; no communication."""
    from torch.distributed.tensor import distribute_tensor

    d = distribute_tensor(x, mesh, placements, src_data_rank=None)
    shard = d.to_local()
    if shard.untyped_storage().nbytes() > shard.nbytes:
        d = like(d, shard.clone())      # free the full value's storage
    return d


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` as a DTensor placed by its spec (:func:`place`).
    """
    flat = iter(_leaves(specs))
    return _map_with_path(
        lambda _, x: place(x, mesh, to_placements(next(flat), mesh)), tree)


# ------------------------------------------------- DTensor leaves at use --
def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor())


def local(x):
    """A DTensor's local shard (sharing its storage); anything else as it
    is."""
    return x.to_local() if is_dtensor(x) else x


def replicas(x) -> int:
    """How many ranks hold the same shard of a DTensor (1 for a plain
    tensor): the product of its replicated mesh dims' sizes."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    return int(np.prod([mesh.size(i) for i, pl in enumerate(x.placements)
                        if isinstance(pl, Replicate)]))


def like(ref, t):
    """``t``, a local shard of ``ref``'s layout, as a DTensor placed like
    ``ref`` (no communication); ``t`` itself where ``ref`` is plain."""
    if not is_dtensor(ref):
        return t
    return _dtensor().from_local(t, ref.device_mesh, ref.placements,
                                 run_check=False, shape=ref.shape,
                                 stride=ref.stride())


def gather(tree):
    """Every DTensor leaf as its full plain tensor (an all-gather).  Under
    autograd its gradient flows back as a partial sum, which DTensor turns
    into a reduce-scatter (or an all-reduce) into the leaf's own
    placements.  A tree without DTensors comes back as it is."""
    DT = _dtensor()
    if not any(isinstance(x, DT) for x in _leaves(tree)):
        return tree
    from torch.distributed.tensor import Partial

    def full(_, x):
        if not isinstance(x, DT):
            return x
        return x.full_tensor(grad_placements=[Partial()] * x.device_mesh.ndim)
    return _map_with_path(full, tree)


def all_sum(t, tree):
    """``t`` summed over every rank when ``tree`` holds DTensors (one
    all-reduce, in place); ``t`` itself otherwise.  The meshes span the
    default group."""
    if any(is_dtensor(x) for x in _leaves(tree)):
        import torch.distributed as dist
        dist.all_reduce(t)
    return t


__all__ = ["MeshView", "P", "TP", "all_sum", "batch_specs", "cache_specs",
           "data_axes", "distribute", "fit_spec", "gather", "is_dtensor",
           "like", "local", "param_specs", "place", "replicas", "to_placements",
           "to_shardings", "view"]
