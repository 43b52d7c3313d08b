"""Activation-sharding context: the JAX package's ``parallel/ctx.py``.

The trainer and the dry run call ``set_policy(mesh)`` (or enter
``policy(mesh)``); on one device nothing sets it and ``constrain`` is a
no-op.  ``constrain`` / ``constrain_acts`` redistribute a DTensor to the
spec and return a plain tensor unchanged.  The port's sharded step gathers
each layer's parameters and runs the model on plain tensors (each rank its
batch shard), so the model's activations are never DTensors and the model
calls neither function (the JAX package's calls in ``models/*`` are
hints to GSPMD; see ``repro_torch.models.model``).
"""
from __future__ import annotations

from contextlib import contextmanager

from repro_torch.parallel.sharding import P, TP, to_placements, view

_POLICY: dict | None = None


def set_policy(mesh, dp_all_axes: bool = False) -> None:
    global _POLICY
    if mesh is None:
        _POLICY = None
        return
    names = view(mesh).axis_names
    if dp_all_axes:                      # fsdp_only: batch over every axis
        dp = tuple(names)
    else:
        d_ax = tuple(a for a in names if a != TP)
        dp = d_ax if len(d_ax) > 1 else d_ax[0]
    _POLICY = {"mesh": mesh, "dp": dp, "dp_all": dp_all_axes}


@contextmanager
def policy(mesh, dp_all_axes: bool = False):
    global _POLICY
    old = _POLICY
    set_policy(mesh, dp_all_axes)
    try:
        yield
    finally:
        _POLICY = old


def active() -> bool:
    return _POLICY is not None


def dp_all() -> bool:
    """True when the batch axes cover the whole mesh (fsdp_only)."""
    return bool(_POLICY and _POLICY.get("dp_all"))


def constrain(x, *spec):
    """Redistribute a DTensor to P(*spec), where 'dp' is replaced by the
    data axes tuple; anything else comes back as it is."""
    from torch.distributed.tensor import DTensor

    if _POLICY is None or not isinstance(x, DTensor):
        return x
    spec = tuple(_POLICY["dp"] if s == "dp" else s for s in spec)
    mesh = _POLICY["mesh"]
    return x.redistribute(mesh, to_placements(P(*spec), mesh))


def constrain_acts(x, mode: str):
    """Layer-boundary activation sharding: (B, S, d).

    mode="seq"    -> P(dp, "model", None)   sequence parallelism
    mode="dmodel" -> P(dp, None, "model")   feature sharding (SSM stacks)
    mode="batch"  -> P(dp, None, None)
    """
    if _POLICY is None:
        return x
    if x.ndim != 3 or x.shape[1] == 1:          # decode: batch-only
        mode = "batch"
    if _POLICY.get("dp_all"):   # fsdp_only: "model" is a data axis already
        mode = "batch"
    if mode == "seq":
        return constrain(x, "dp", "model", None)
    if mode == "dmodel":
        return constrain(x, "dp", None, "model")
    return constrain(x, "dp", *([None] * (x.ndim - 1)))


def _dp_group():
    """The process group of the batch axes (cached in the policy)."""
    if "group" not in _POLICY:
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        dp = _POLICY["dp"]
        names = dp if isinstance(dp, tuple) else (dp,)
        mesh = _POLICY["mesh"]
        if len(names) == mesh.ndim:
            _POLICY["group"] = dist.group.WORLD
        elif len(names) == 1:
            _POLICY["group"] = mesh.get_group(names[0])
        else:               # the mesh's own rank tensors, never fake ones
            with unset_fake_temporarily():
                _POLICY["group"] = mesh[names]._flatten().get_group()
    return _POLICY["group"]


def batch_mean(x):
    """The mean over the batch ranks of a statistic each rank took over its
    own batch shard: what a mean over the whole (GSPMD-sharded) batch is in
    the JAX package.  Differentiable (its backward sums the cotangents over
    the same ranks).  ``x`` itself with no policy or one batch rank."""
    if _POLICY is None or getattr(_POLICY["mesh"], "ndim", None) is None:
        return x
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    group = _dp_group()
    n = dist.get_world_size(group)
    if n == 1:
        return x
    return all_reduce(x, group=group) / n


__all__ = ["active", "batch_mean", "constrain", "constrain_acts", "dp_all",
           "policy", "set_policy"]
