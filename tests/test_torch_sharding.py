"""The port's sharding rule tables (``repro_torch.parallel.sharding``) and
abstract trees (``repro_torch.launch.steps``) held against the JAX
package's, on the CPU.

One stand-in mesh (``FakeMesh``: ``.shape`` and ``.axis_names``) drives
both packages' rule tables.  The JAX package's trees are taken in its list
layout (``scan_layers=False``), the port's only layout, and compared leaf
by leaf by path; specs must be equal exactly.  The DTensor placements a
spec becomes are held against ``NamedSharding.devices_indices_map`` of a
JAX mesh of 8 forced host devices (a subprocess), rank by rank.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import steps as JST
from repro.parallel import sharding as JSH

from repro_torch import configs
from repro_torch.launch import steps as ST
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import P

SRC = str(Path(__file__).resolve().parents[1] / "src")


class FakeMesh:
    """Just enough Mesh surface for both packages' spec builders."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}
MODES = ("train", "serve", "prefill", "decode")


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, dtype=None):
    cfg = jconfigs.get_config(arch).replace(scan_layers=False)
    return JST.abstract_params(cfg, dtype)


@functools.lru_cache(maxsize=None)
def port_params(arch: str, dtype=None):
    return ST.abstract_params(configs.get_config(arch), dtype)


def jax_by_path(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {JSH._path_str(p): x for p, x in flat}


def port_by_path(tree) -> dict:
    out = {}
    SH._map_with_path(lambda p, x: out.__setitem__(SH._path_str(p), x), tree)
    return out


def assert_same_specs(port_tree, jax_tree, what: str) -> None:
    t, j = port_by_path(port_tree), jax_by_path(jax_tree)
    assert sorted(t) == sorted(j), what
    bad = {k: (t[k], j[k]) for k in j if tuple(t[k]) != tuple(j[k])}
    assert not bad, (what, bad)


# ============================================================ rule parity ===
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_specs_match_jax(arch, mesh):
    """Every mode, with fsdp_only off and on, moe_ep as the config sets it;
    train trees in f32, serve trees in bf16 (the dry run's dtypes)."""
    m = FakeMesh(MESHES[mesh])
    moe_ep = configs.get_config(arch).moe_ep
    for mode in MODES:
        dt = None if mode == "train" else "bf16"
        jp = jax_params(arch, None if dt is None else JST.SERVE_DTYPE)
        tp = port_params(arch, None if dt is None else ST.SERVE_DTYPE)
        for fsdp_only in (False, True):
            assert_same_specs(
                SH.param_specs(tp, m, mode=mode, fsdp_only=fsdp_only,
                               moe_ep=moe_ep),
                JSH.param_specs(jp, m, mode=mode, fsdp_only=fsdp_only,
                                moe_ep=moe_ep),
                (arch, mesh, mode, fsdp_only))


def jax_batch(cfg, B, S, kind):
    b = JST.abstract_batch(cfg, B, S, kind)
    if cfg.mrope_sections:
        b["positions"] = jax.ShapeDtypeStruct((3, B, S), np.int32)
    return b


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_batch_specs_match_jax(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    for B, S, kind in ((256, 4096, "train"), (32, 512, "prefill"),
                       (1, 1, "decode"), (6, 8, "train")):
        jb = jax_batch(jcfg, B, S, kind)
        tb = ST.abstract_batch(tcfg, B, S, kind)
        if "positions" in jb:
            tb["positions"] = np.zeros((3, B, S), np.int32)
        for all_axes in (False, True):
            for seq in (False, True):
                assert_same_specs(
                    SH.batch_specs(tb, m, all_axes=all_axes,
                                   seq_over_model=seq),
                    JSH.batch_specs(jb, m, all_axes=all_axes,
                                    seq_over_model=seq),
                    (arch, mesh, B, kind, all_axes, seq))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_cache_specs_match_jax(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    jcfg = jconfigs.get_config(arch).replace(scan_layers=False)
    tcfg = configs.get_config(arch)
    for B in (128, 1):
        jc = JST.abstract_cache(jcfg, B, 1024)
        tc = ST.abstract_cache(tcfg, B, 1024)
        assert_same_specs(SH.cache_specs(tcfg, tc, m, B),
                          JSH.cache_specs(jcfg, jc, m, B), (arch, mesh, B))


# ====================================== the JAX TestParamSpecs, ported ======
class TestParamSpecs:
    """``tests/test_sharding.py::TestParamSpecs`` on the port's list layout
    (no leading stacked-layer dim)."""

    mesh = FakeMesh({"data": 16, "model": 16})

    def _specs(self, arch):
        params = port_params(arch)
        return params, SH.param_specs(params, self.mesh)

    def test_dense_rules(self):
        _, specs = self._specs("yi-6b")
        layer = specs["layers"][0]
        assert layer["attn"]["wq"]["w"] == P("data", "model")
        assert layer["attn"]["wo"]["w"] == P("model", "data")
        assert layer["mlp"]["down"]["w"] == P("model", "data")
        assert layer["norm1"]["g"] == P(None)
        assert specs["embed"]["table"] == P("model", None)
        assert specs["head"]["w"] == P("data", "model")

    def test_moe_rules(self):
        _, specs = self._specs("grok-1-314b")
        moe = specs["layers"][0]["moe"]
        assert moe["gate"] == P(None, "data", "model")
        assert moe["down"] == P(None, "model", "data")
        assert moe["router"]["w"] == P(None, None)

    def test_expert_parallel_rules(self):
        params = port_params("jamba-v0.1-52b")
        specs = SH.param_specs(params, self.mesh, moe_ep=True)
        moe = next(lp["moe"] for lp in specs["layers"] if "moe" in lp)
        assert moe["gate"] == P("model", "data", None)
        assert moe["down"] == P("model", None, "data")

    def test_nondivisible_dims_dropped(self):
        _, specs = self._specs("granite-moe-1b-a400m")
        assert specs["embed"]["table"] == P(None, None)

    def test_every_leaf_divides(self):
        for arch in configs.ARCH_NAMES:
            params, specs = self._specs(arch)
            for (path, leaf), spec in zip(port_by_path(params).items(),
                                          port_by_path(specs).values()):
                for dim, ax in zip(leaf.shape, spec):
                    if ax is None:
                        continue
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    n = int(np.prod([self.mesh.shape[a] for a in axes]))
                    assert dim % n == 0, (arch, path, leaf.shape, spec)

    def test_cache_specs_batch_vs_seq(self):
        cfg = configs.get_config("yi-6b")
        specs = SH.cache_specs(cfg, ST.abstract_cache(cfg, 128, 1024),
                               self.mesh, 128)
        assert specs[0]["k"] == P("data", "model", None, None)
        specs1 = SH.cache_specs(cfg, ST.abstract_cache(cfg, 1, 1024),
                                self.mesh, 1)
        assert specs1[0]["k"] == P(None, ("data", "model"), None, None)


# ============================================================ placements ====
def test_to_placements_in_mesh_order_only():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert SH.to_placements(P(("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    assert SH.to_placements(P(None, None), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        SH.to_placements(P(("model", "data")), m)
    with pytest.raises(ValueError, match="used twice"):
        SH.to_placements(P("data", "data"), m)


_JAX_INDICES = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, {src!r})
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
cases = json.loads(sys.argv[1])
out = []
for shape, spec in cases:
    spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out.append([[[s.start or 0, (s.stop if s.stop is not None else n)]
                 for s, n in zip(m[d], shape)] for d in jax.devices()])
print(json.dumps(out))
"""


def distinct_specs(arch: str, mesh) -> list:
    """(shape, spec) of every distinct leaf of tiny ``arch``'s params in
    every mode, its cache at B = 4 and B = 1 and its train batch."""
    cfg = configs.get_tiny_config(arch)
    params = ST.abstract_params(cfg)
    out = set()
    for mode in MODES:
        for fsdp_only in (False, True):
            specs = SH.param_specs(params, mesh, mode=mode,
                                   fsdp_only=fsdp_only, moe_ep=cfg.moe_ep)
            out |= {(tuple(x.shape), tuple(s)) for x, s in zip(
                port_by_path(params).values(), port_by_path(specs).values())}
    for B in (4, 1):
        cache = ST.abstract_cache(cfg, B, 64)
        out |= {(tuple(x.shape), tuple(s)) for x, s in zip(
            port_by_path(cache).values(),
            port_by_path(SH.cache_specs(cfg, cache, mesh, B)).values())}
    batch = ST.abstract_batch(cfg, 8, 16, "train")
    for all_axes in (False, True):
        out |= {(tuple(x.shape), tuple(s)) for x, s in zip(
            batch.values(), SH.batch_specs(batch, mesh,
                                           all_axes=all_axes).values())}
    return sorted(out, key=repr)


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b"])
def test_placements_give_each_rank_the_chunk_jax_gives_it(arch, tmp_path):
    """DTensor's local shard of rank r (mesh coordinate (r // 2, r % 2))
    on a fake group of 8 equals JAX's shard of device r on a 4 x 2
    ``Mesh`` (``jax.sharding.Mesh``: no Explicit axes), offsets and
    shapes, for every distinct spec of tiny ``arch``."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    cases = distinct_specs(arch, FakeMesh(MESHES["4x2"]))
    enc = [[list(shape), [list(a) if isinstance(a, tuple) else a
                          for a in spec]] for shape, spec in cases]
    r = subprocess.run([sys.executable, "-c", _JAX_INDICES.format(src=SRC),
                        json.dumps(enc)], capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.splitlines()[-1])
    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            mesh = make_mesh((4, 2))
            for (shape, spec), jax_idx in zip(cases, want):
                local, off = compute_local_shape_and_global_offset(
                    shape, mesh, SH.to_placements(P(*spec), mesh))
                got = [[o, o + n] for o, n in zip(off, local)]
                assert got == jax_idx[rank], (rank, shape, spec)
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ========================================================= abstract trees ===
def shapes_by_path(tree, jax_side: bool) -> dict:
    if jax_side:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {JSH._path_str(p): (tuple(x.shape), np.dtype(x.dtype).name)
                for p, x in flat}
    return {k: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for k, x in port_by_path(tree).items()}


def same_trees(port_tree, jax_tree, what) -> None:
    t = shapes_by_path(port_tree, False)
    j = shapes_by_path(jax_tree, True)
    assert t == j, (what, {k: (t.get(k), j.get(k))
                           for k in set(t) | set(j) if t.get(k) != j.get(k)})


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_abstract_trees_match_jax_eval_shape(arch):
    """Params (f32 and bf16), AdamW state (its moment dtype), every
    applicable cell's batch and cache: shapes and dtypes leaf by leaf."""
    jcfg = jconfigs.get_config(arch).replace(scan_layers=False)
    tcfg = configs.get_config(arch)
    for dt in (None, "bf16"):
        same_trees(port_params(arch, None if dt is None else ST.SERVE_DTYPE),
                   jax_params(arch, None if dt is None else JST.SERVE_DTYPE),
                   (arch, dt))
    jo = JST.abstract_opt(jcfg, jax_params(arch))
    to = ST.abstract_opt(tcfg, port_params(arch))
    same_trees({"m": to.m, "v": to.v, "count": to.count},
               {"m": jo.m, "v": jo.v, "count": jo.count}, (arch, "opt"))
    for name, shape in configs.SHAPES.items():
        if not configs.shape_applicable(tcfg, shape)[0]:
            continue
        B, S = shape.global_batch, shape.seq_len
        kind = shape.kind
        same_trees(ST.abstract_batch(tcfg, B, 1 if kind == "decode" else S,
                                     kind),
                   JST.abstract_batch(jcfg, B, 1 if kind == "decode" else S,
                                      kind), (arch, name))
        if kind == "decode":
            same_trees(ST.abstract_cache(tcfg, B, S),
                       JST.abstract_cache(jcfg, B, S), (arch, name, "cache"))


def test_input_specs_cells():
    """``input_specs`` builds every applicable cell's fake arguments in one
    mode, without memory, and the step kinds of the JAX package's."""
    for arch, shape, ok, _ in configs.all_cells(include_skipped=True):
        if not ok:
            continue
        cell = ST.input_specs(arch, shape)
        jcell_kind = configs.SHAPES[shape].kind
        assert cell.kind == jcell_kind
        assert len(cell.args) == {"train": 3, "prefill": 2, "decode": 4}[
            cell.kind]
        assert cell.mode is not None and cell.donate == {
            "train": (0, 1), "prefill": (), "decode": (1,)}[cell.kind]
        if cell.kind == "decode":
            assert cell.args[3] == configs.SHAPES[shape].seq_len - 1
