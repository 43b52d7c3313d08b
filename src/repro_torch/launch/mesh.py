"""Production mesh construction: ``torch.distributed`` device meshes over
the default process group.

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group).  The device type follows the group's backend: ``"cuda"``
for NCCL, ``"cpu"`` for gloo or the dry run's fake group; a caller may
name it (gloo carrying CUDA tensors: ranks that share one card, where
NCCL takes one rank a device).  A mesh larger than the world raises, as
the JAX package's ``parse_mesh`` asserts.
"""
from __future__ import annotations

import math

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple, axis_names: tuple | None = None,
              device: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ("data", "model") or ("pod",
    "data", "model") over the initialised default group, on ``device``
    (a device type; default the backend's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device or device_type(), tuple(shape),
                            mesh_dim_names=axis_names or AXES[len(shape)])


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh((2, 16, 16) if multi_pod else (16, 16))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """Small mesh over however many ranks the group has."""
    if pod:
        return make_mesh((pod, data, model))
    return make_mesh((data, model))


MESHES = {
    "single": dict(multi_pod=False),   # 16 x 16 = 256 chips (one pod)
    "multi": dict(multi_pod=True),     # 2 x 16 x 16 = 512 chips (two pods)
}

__all__ = ["AXES", "MESHES", "device_type", "make_mesh",
           "make_production_mesh", "make_test_mesh"]
