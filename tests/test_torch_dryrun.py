"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.roofline.analysis``) on the CPU.

The dry run traces one rank of a fake process group under
``FakeTensorMode``; these tests hold its pieces: the collective-bytes
record, ``run_cell`` on a 4 x 2 fake mesh for the cells of
``tests/test_dryrun_small.py`` (tiny configs, shrunk shapes), the argument
bytes per device of a full-size cell against the JAX package's own rule
table and abstract trees (numpy arithmetic), the SKIP lines' reasons, and
``tests/test_roofline.py``'s cases with the H100's constants.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import steps as JST
from repro.parallel import sharding as JSH

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           Terms, summarize)


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ============================================================ collectives ===
def test_collective_bytes():
    out = DR.collective_bytes([("all-gather", 8 * 128 * 2),
                               ("all-reduce", 256 * 4),
                               ("reduce-scatter", 256 * 4),
                               ("collective-permute", 16 * 4),
                               ("all-gather", 10)])
    assert out["all-gather"] == 8 * 128 * 2 + 10
    assert out["all-reduce"] == 256 * 4
    assert out["reduce-scatter"] == 256 * 4
    assert out["collective-permute"] == 16 * 4
    assert out["all-to-all"] == 0
    assert out["counts"] == {"all-gather": 2, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 1}
    assert out["total"] == sum(v for k, v in out.items()
                               if k not in ("counts", "total"))


def test_recorder_counts_the_operands_dtensor_sends(fake_group):
    """A (16, 8) f32 tensor split over both dims of a 4 x 2 mesh, gathered
    whole: DTensor gathers over "model" (a 64-byte operand), then over
    "data" (128 bytes); its gradient comes back as one reduce-scatter a
    mesh dim, over "data" of the full 512 bytes, then over "model" of the
    128 left."""
    import torch
    from torch.distributed.tensor import Partial, Shard

    mesh = DR.make_mesh_by_name("4x2")
    with ST.fake_mode():
        w = torch.distributed.tensor.distribute_tensor(
            torch.randn(16, 8), mesh, [Shard(0), Shard(0)],
            src_data_rank=None).requires_grad_(True)
        rec = DR._comm_recorder()
        with rec:
            full = w.full_tensor(grad_placements=[Partial(), Partial()])
            full.sum().backward()
    got = DR.collective_bytes(rec.records)
    assert got["counts"]["all-gather"] == 2
    assert got["all-gather"] == 64 + 128
    assert got["counts"]["reduce-scatter"] == 2
    assert got["reduce-scatter"] == 512 + 128


# ================================================================ cells =====
@pytest.mark.parametrize("arch,shape", [
    ("yi-6b", "decode_32k"),            # dense serve, fsdp_only arch
    ("jamba-v0.1-52b", "train_4k"),     # hybrid + MoE + EP train
])
def test_small_mesh_cell_traces(arch, shape, tmp_path, monkeypatch,
                                fake_group):
    """``run_cell`` on a 4 x 2 fake mesh with tiny configs, batch 8
    (``tests/test_dryrun_small.py``'s cells) and 64 tokens (its 256 at a
    quarter: the plain scan's backward recompute is a Python loop over the
    tokens, traced op by op)."""
    cfg = configs.get_tiny_config(arch)
    orig = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda a: cfg if a == arch else orig(a))
    sh = configs.SHAPES[shape]
    monkeypatch.setitem(configs.SHAPES, shape,
                        ShapeConfig(sh.name, 64, 8, sh.kind))
    rec = DR.run_cell(arch, shape, "4x2", out_dir=tmp_path, verbose=False)
    assert rec["n_chips"] == 8 and rec["kind"] == sh.kind
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["peak_in_bytes"] >= mem["argument_size_in_bytes"]
    coll = rec["collectives"]
    assert coll["total"] > 0 and coll["counts"]["all-gather"] > 0
    if sh.kind == "train":          # gradients reduce-scatter to the shards
        assert coll["counts"]["reduce-scatter"] > 0
    assert json.loads((tmp_path / f"{arch}__{shape}__4x2.json").read_text()
                      )["cost"]["flops"] == rec["cost"]["flops"]


def jax_bytes_per_device(tree, specs, mesh) -> int:
    """The bytes one device holds of ``tree`` placed by ``specs``."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, spec_leaves, strict=True):
        n = 1
        for dim, ax in zip(x.shape, tuple(spec) + (None,) * x.ndim):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            n *= dim // int(np.prod([mesh.shape[a] for a in axes]))
        total += n * np.dtype(x.dtype).itemsize
    return total


def test_full_size_argument_bytes_match_the_jax_rule_table(fake_group):
    """qwen3-8b train_4k on the 16 x 16 mesh: the dry run's argument bytes
    per device (params, AdamW state and batch shards) equal what the JAX
    package's ``param_specs`` / ``batch_specs`` imply on its own abstract
    trees."""
    arch, shape = "qwen3-8b", "train_4k"
    jcfg = jconfigs.get_config(arch)
    m = FakeMesh({"data": 16, "model": 16})
    jp = JST.abstract_params(jcfg)
    jo = JST.abstract_opt(jcfg, jp)
    jb = JST.abstract_batch(jcfg, 256, 4096, "train")
    ps = JSH.param_specs(jp, m, fsdp_only=jcfg.fsdp_only, moe_ep=jcfg.moe_ep)
    want = (3 * jax_bytes_per_device(jp, ps, m)        # params, m, v
            + jax_bytes_per_device(jo.count, jax.sharding.PartitionSpec(), m)
            + jax_bytes_per_device(jb, JSH.batch_specs(
                jb, m, all_axes=jcfg.fsdp_only), m))
    mesh = DR.make_mesh_by_name("single")
    cell = ST.input_specs(arch, shape)
    with cell.mode:
        args, _ = DR._placed(cell, mesh, 256)
        got = DR._local_bytes(args)
    assert got == want


def test_skip_lines_carry_the_jax_reasons(tmp_path, capsys):
    assert DR.main(["--arch", "yi-6b", "--shape", "long_500k",
                    "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    _, why = jconfigs.shape_applicable(jconfigs.get_config("yi-6b"),
                                       jconfigs.SHAPES["long_500k"])
    assert f"[dryrun] SKIP yi-6b x long_500k: {why}" in out
    assert "all 0 cells traced OK" in out


# ============================================================== roofline ====
class TestTerms:
    def test_dominant_and_fraction(self):
        t = Terms(compute_s=1.0, memory_s=2.0, collective_s=0.5)
        assert t.dominant == "memory"
        assert t.bound_s == 2.0
        assert t.compute_fraction == 0.5

    def test_compute_bound_ideal(self):
        t = Terms(compute_s=3.0, memory_s=1.0, collective_s=1.0)
        assert t.dominant == "compute"
        assert t.compute_fraction == 1.0

    def test_hardware_constants(self):
        # H100 SXM5 80GB at 700 W: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
        # 50 GB/s a GPU between nodes (NDR InfiniBand, 400 Gbit/s)
        assert PEAK_FLOPS == 989e12
        assert HBM_BW == 3.35e12
        assert LINK_BW == 50e9


def test_summarize_table_shape():
    recs = [dict(arch="a", shape="s", compute_s=1e-3, memory_s=2e-3,
                 collective_s=3e-3, dominant="collective",
                 compute_fraction=0.33, useful_flops_ratio=0.9)]
    lines = summarize(recs).splitlines()
    assert lines[0].startswith("| arch ")
    assert "**collective**" in lines[2]
    assert "0.33" in lines[2]


def test_extrapolation_math():
    """base + (L/period)*per_period recovers linear-in-depth totals."""
    L, period = 32, 8
    per_layer_true, base_true = 7.0, 100.0
    t1 = base_true + period * per_layer_true
    t2 = base_true + 2 * period * per_layer_true
    per_period = t2 - t1
    base = t1 - per_period
    assert base + (L / period) * per_period == base_true + L * per_layer_true


def test_analyze_cell_extrapolates_the_traced_variants(tmp_path, monkeypatch,
                                                       fake_group):
    """A tiny cell traced whole and at one and two layers: the
    extrapolated FLOP equal the whole cell's (the trace runs every layer),
    the terms are those FLOP, bytes and collective bytes over the H100's
    rates, and the useful ratio is the JAX package's formula."""
    arch, shape = "yi-6b", "decode_32k"
    cfg = configs.get_tiny_config(arch)
    orig = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda a: cfg if a == arch else orig(a))
    monkeypatch.setitem(configs.SHAPES, shape,
                        ShapeConfig(shape, 256, 8, "decode"))
    monkeypatch.setattr(DR, "make_mesh_by_name",
                        lambda name, f=DR.make_mesh_by_name: f("4x2"))
    base = DR.run_cell(arch, shape, "single", out_dir=tmp_path / "dr",
                       verbose=False)
    rec = RA.analyze_cell(arch, shape, "single", dryrun_dir=tmp_path / "dr",
                          out_dir=tmp_path / "rl")
    np.testing.assert_allclose(rec["flops_per_dev"], base["cost"]["flops"],
                               rtol=1e-9)
    assert rec["compute_s"] == rec["flops_per_dev"] / PEAK_FLOPS
    assert rec["memory_s"] == rec["bytes_per_dev"] / HBM_BW
    assert rec["collective_s"] == rec["coll_bytes_per_dev"] / LINK_BW
    assert rec["useful_flops_ratio"] == pytest.approx(
        2.0 * cfg.active_param_counts() * 8 / (rec["flops_per_dev"] * 8))
    assert rec["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_traced_segment_op_is_the_plain_scan_and_its_gradient(kind,
                                                              with_state):
    """The dry run's one-op stand-in for a training segment's recompute
    (``dryrun._traced_ref``) returns the plain scan's values, and its VJP
    op the plain scan's gradients, on real tensors."""
    import torch
    gen = torch.Generator().manual_seed(3)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).requires_grad_()
    if kind == "mamba":
        B, S, di, ds = 2, 5, 6, 4
        args = [rand(B, S, di), rand(B, S, di, scale=0.1).abs(),
                rand(B, S, ds), rand(B, S, ds), -rand(di, ds).abs(),
                rand(di)]
        state = rand(B, di, ds) if with_state else None
    else:
        B, S, H, hd = 2, 5, 2, 4
        args = [rand(B, S, H, hd), rand(B, S, H, hd), rand(B, S, H, hd),
                torch.rand((B, S, H, hd), generator=gen,
                           dtype=torch.float64).mul(0.1).add(0.85)
                .requires_grad_(), rand(H, hd)]
        state = rand(B, H, hd, hd) if with_state else None
    wrt = args + ([state] if state is not None else [])
    outs = []
    for fn in (DR._scan_ref(kind), DR._traced_ref(kind)):
        y, st = fn(*args, state)
        grads = torch.autograd.grad((y * y.detach()).sum() + st.sum(), wrt)
        outs.append((y, st, grads))
    (y1, s1, g1), (y2, s2, g2) = outs
    torch.testing.assert_close(y2, y1, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(s2, s1, rtol=1e-12, atol=1e-12)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
