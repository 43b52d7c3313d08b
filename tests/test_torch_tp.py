"""The port's tensor parallelism on the "model" axis, on the CPU: gloo jobs
of the sharded Trainer and the sharded prefill held against the port's
one-process step and prefill.

The jobs run as ``tests/test_torch_mesh.py``'s do: one process a rank,
a ``file://`` store in ``tmp_path``, a 60 s group timeout, one thread a
rank, a timeout on the whole job.  The configs are the three whose rule
tables shard over "model" (tiny qwen2.5-32b, grok-1-314b with 4 experts
not split over ranks, jamba-v0.1-52b with ``moe_ep``), and every module of
theirs runs its tensor-parallel form on a "model" axis wider than 1.
Expectations, each with its reason:
  - one step on 2 x 2, 1 x 4 and 4 x 2, without and with int8, equals the
    one-process Trainer's step: the loss within 1e-5 relative, the params
    within 1e-5, and without compression the first moment (0.1 of the
    clipped gradient) within 1e-5 of each leaf's largest.  The steps take
    Adam eps 1e-6, as ``tests/test_torch_mesh.py``'s do: the "model" ranks
    add row-parallel partial sums in another order than one GEMM, and at
    the default eps 1e-8 the first Adam step, about g / (|g| + eps), moves
    an element whose |g| lies within a few eps of zero by up to lr on such
    a last-ulp difference; at 1e-6 it moves by at most lr / eps = 300 times
    the gradient's difference;
  - the batches hold every config's ``grad_accum`` microbatches with the
    same rows as the one-process step (grok-1's 16 need 64 rows on 4 data
    ranks): the router's load-balance loss depends on the rows it sees;
  - tiny qwen2.5-32b with 10 heads and 2 KV heads on 1 x 4 (2.5 q heads
    and half a KV head of columns a rank, as qwen2.5-32b at 16) equals its
    one-process step: the head exchange forms whole heads; so does 10 and
    5, where one rank's heads read their KV heads repeated;
  - tiny qwen3-8b with qk-norm and ``fsdp_only`` off on 1 x 2 equals its
    one-process step: the replicated norm weights' gradients add the
    ranks' heads;
  - tiny Jamba at tp 2 and 4 pairs each rank's x and z channels (a rank's
    contiguous ``in_proj`` columns are x's or z's alone);
  - rank 0's FlopCounterMode count of a tiny qwen2.5-32b step on 1 x 4 is
    at most a quarter of the one-process count plus 1 %: every counted
    product (projections, attention, the vocab head) is split over the 4
    ranks, and the replicated parts (norms, RoPE, softmax) count no FLOP;
    a "model" axis that only partitions storage repeats the whole count;
  - a run saved at step 4 on 2 x 2 and restored on 1 x 4 and 4 x 1 ends
    step 8 with the uninterrupted run's losses within 1e-5 relative;
  - the prefill on 1 x 2 and 1 x 4 equals the one-process prefill: the
    last logits, the KV, conv and SSM caches within 1e-5 of their scale;
  - ``python -m repro_torch.launch.train --mesh 1x2`` under a 2-rank gloo
    job ends with the one-process run's loss within 1e-5 relative.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.models import attention as A
from repro_torch.models import model as MD
from repro_torch.parallel import ctx as pctx

SRC = str(Path(__file__).resolve().parents[1] / "src")
SEQ = 32
LR = 3e-4
EPS = 1e-6
#: (arch, batch): each config's grad_accum microbatches of equal rows
#: on every mesh (grok-1's 16 microbatches of 4 rows)
CASES = [("qwen2.5-32b", 16), ("grok-1-314b", 64), ("jamba-v0.1-52b", 16)]
COMPRESS = ("none", "int8")
MESHES = ("2x2", "1x4", "4x2")
#: tiny qwen2.5-32b with heads that do not divide over 4 ranks: qwen2.5-32b's
#: heads a rank at 16 (10 / 4 = 2.5, G 5), and a split whose rank 1 holds
#: q heads 2-4 of KV groups of 2 (its KV heads read repeated, G 1)
UNEVEN = {"10-2": dict(n_heads=10, n_kv_heads=2),
          "10-5": dict(n_heads=10, n_kv_heads=5)}
PREFILL = dict(batch=2, seq=24, seed=3)
FLOP_BOUND = 0.25 * 1.01
CLI_STEPS = 3
ARCHS = tuple(configs.ARCH_NAMES)
FSDP_ONLY = tuple(a for a in ARCHS if configs.get_tiny_config(a).fsdp_only)
#: decode: a one-process prefill of ``prompt`` tokens into a cache of
#: ``max_len`` positions (divisible by 2 and 4 ranks), then ``steps`` steps
#: whose writes land on two ranks' blocks (positions 10-12: ranks 0 and 1
#: of 2, 1 and 2 of 4; rank 3's block holds no valid key yet)
DECODE = dict(prompt=10, max_len=24, steps=3, seed=5, batch=2)
#: decode on 1 x 4: qwen2.5-32b's uneven heads, the MoE's d_ff split,
#: expert parallelism with Mamba channels, RWKV heads, and RWKV with 2
#: heads on 4 ranks (the rule table leaves its state whole; each rank's
#: columns cut a head)
DECODE_1X4 = {"qwen2.5-32b-10-2": ("qwen2.5-32b", UNEVEN["10-2"]),
              "grok-1-314b": ("grok-1-314b", {}),
              "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
              "rwkv6-3b": ("rwkv6-3b", {}),
              "rwkv6-3b-2-heads": ("rwkv6-3b", dict(rwkv_head_size=32))}
#: decode on 2 x 2 at B 2 (the batch over "data", the sequence over
#: "model") and B 1 (the sequence over every axis)
DECODE_2X2 = ("qwen2.5-32b", "jamba-v0.1-52b")
SPLIT_1X4 = ("rwkv6-3b", "granite-moe-1b-a400m")
#: tiny granite's capacity factor lowered until its prefill drops entries
CAPACITY = 0.5

WORKER = r'''
import os, shutil, sys
from contextlib import redirect_stdout
from datetime import timedelta
from io import StringIO
rank, world, rdv, out, job = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
from torch.utils.flop_counter import FlopCounterMode
from repro_torch._tree import leaves
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.launch.train import Trainer, get_cfg, parse_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.models import model as MD
from repro_torch.models import moe as X
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as SH
quiet = dict(log=lambda *a: None)


def save(name, obj):
    if rank == 0:
        torch.save(obj, os.path.join(out, name + ".pt"))


def step(tag, cfg, mesh, batch, compress):
    tr = Trainer(cfg, mesh=mesh, compress=compress, seed=0, eps={eps})
    losses = tr.run(1, batch, {seq}, seed=0, **quiet)
    save(tag, {{"losses": losses,
               "params": [x.full_tensor() for x in leaves(tr.params)],
               "m": [x.full_tensor() for x in leaves(tr.opt.m)]}})


def prefill(tag, cfg, mesh):
    params = MD.init_params(0, cfg, device="cpu")
    params = steps.shard_params(params, cfg, mesh, mode="prefill")
    b = MD.dummy_batch(cfg, {batch}, {pseq}, kind="prefill", gen={pseed},
                       device="cpu")
    with torch.inference_mode(), pctx.policy(mesh):
        logits, cache = MD.apply_prefill(params, cfg, b)
    save(tag, {{"logits": logits, "cache": cache}})


def whole(x, like, dims=(0,)):
    """``x``, this rank's shard of a tensor split as ``like``'s dims
    ``dims`` are (replicated elsewhere), gathered whole."""
    pl = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
          for p in like.placements]
    return DTensor.from_local(x, like.device_mesh, pl).full_tensor()


def decode(tag, cfg, mesh, B):
    """The one-process prefill of {dprompt} tokens into a cache of
    {dmax}, placed by shard_cache, then {dsteps} decode steps on the
    mesh: each step's logits and the cache at the end, gathered whole."""
    params = MD.init_params(0, cfg, device="cpu")
    b = MD.dummy_batch(cfg, B, {dprompt}, kind="prefill", gen={dseed},
                       device="cpu")
    with torch.inference_mode():
        _, cache = MD.apply_prefill(params, cfg, b, max_len={dmax})
    params = steps.shard_params(params, cfg, mesh, mode="decode")
    cache = steps.shard_cache(cache, cfg, mesh, B)
    logits = []
    for t in range({dsteps}):
        tb = MD.dummy_batch(cfg, B, 1, kind="prefill", gen={dseed} + 1 + t,
                            device="cpu")
        tb = SH.distribute(tb, SH.batch_specs(tb, mesh), mesh)
        with torch.inference_mode(), pctx.policy(mesh):
            lg, cache = MD.apply_decode(params, cfg, cache, tb,
                                        {dprompt} + t)
        logits.append(whole(lg, next(iter(tb.values()))))
    save(tag, {{"logits": logits, "cache": [
        {{k: v.full_tensor() for k, v in lc.items()}} for lc in cache]}})


def sp_prefill(tag, cfg, mesh):
    """The prefill with the batch's sequence over "model": the logits and
    the cache gathered whole, and the MoE entries each rank dropped (as
    (row, position, expert) of the whole sequence)."""
    drops = []
    dispatch = X._group_dispatch

    def record(x, gates, idx, E, C, *rest):
        out = dispatch(x, gates, idx, E, C, *rest)
        e = torch.sort(idx.reshape(idx.shape[0], -1), stable=True)[0]
        lo = pctx.tp_rank() * x.shape[1]
        drops.extend((int(g), lo + int(out[3][g, j]), int(e[g, j]))
                     for g, j in (~out[2]).nonzero().tolist())
        return out
    params = MD.init_params(0, cfg, device="cpu")
    params = steps.shard_params(params, cfg, mesh, mode="prefill")
    b = MD.dummy_batch(cfg, {batch}, {pseq}, kind="prefill", gen={pseed},
                       device="cpu")
    b = SH.distribute(b, SH.batch_specs(b, mesh, seq_over_model=True), mesh)
    like = next(iter(b.values()))
    X._group_dispatch = record
    try:
        with torch.inference_mode(), pctx.policy(mesh):
            logits, cache = MD.apply_prefill(params, cfg, b)
    finally:
        X._group_dispatch = dispatch
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, drops)
    save(tag, {{"logits": whole(logits, like), "drops": sorted(
        d for r in got for d in r), "cache": [
        {{k: whole(v, like, (0, 1) if k in ("k", "v") else (0,))
          for k, v in lc.items()}} for lc in cache]}})


if job == "four":
    for shape in ("2x2", "1x4"):
        mesh = parse_mesh(shape)
        for arch, batch in {cases!r}:
            for compress in {compress!r}:
                step(f"{{shape}}-{{arch}}-{{compress}}",
                     get_cfg("tiny:" + arch), mesh, batch, compress)
    mesh = parse_mesh("1x4")
    for tag, heads in {uneven!r}.items():
        step("uneven-" + tag, get_cfg("tiny:qwen2.5-32b").replace(**heads),
             mesh, 16, "none")
    for arch, _ in {cases!r}:
        prefill(f"prefill-1x4-{{arch}}", get_cfg("tiny:" + arch), mesh)
    cfg = get_cfg("tiny:qwen2.5-32b")
    tr = Trainer(cfg, mesh=mesh, seed=0)
    mb = tr._place(SyntheticLM(cfg, 16, {seq}, seed=0,
                               device="cpu").host_batch(0))[0]
    with pctx.policy(mesh), FlopCounterMode(display=False) as fc:
        steps.value_and_grad(tr.params, cfg, mb, 1.0 / tr.batch_ranks)
    save("flops", {{"rank0": fc.get_total_flops()}})
    ref = Trainer(cfg, mesh=parse_mesh("2x2"), seed=0).run(8, 16, {seq},
                                                           **quiet)
    ck = os.path.join(out, "ck")
    tr = Trainer(cfg, ck, mesh=parse_mesh("2x2"), seed=0)
    try:
        tr.run(8, 16, {seq}, ckpt_every=4, crash_at=4, **quiet)
    except RuntimeError:
        pass
    if rank == 0:
        shutil.copytree(ck, ck + "2")
    dist.barrier()
    got = {{}}
    for shape, d in (("1x4", ck), ("4x1", ck + "2")):
        tr = Trainer(cfg, d, mesh=parse_mesh(shape), seed=1)
        assert tr.restore_if_any() and tr.step == 4
        got[shape] = tr.run(8, 16, {seq}, ckpt_every=100, **quiet)
    save("elastic", {{"ref": ref, "got": got}})
    for tag, (arch, replace) in {decode4!r}.items():
        decode("decode-1x4-" + tag, get_cfg("tiny:" + arch).replace(
            **replace), mesh, {dbatch})
    for arch in {split4!r}:
        sp_prefill("split-1x4-" + arch, get_cfg("tiny:" + arch), mesh)
    mesh = parse_mesh("2x2")
    for arch in {decode22!r}:
        for B in (1, {dbatch}):
            decode(f"decode-2x2-B{{B}}-{{arch}}", get_cfg("tiny:" + arch),
                   mesh, B)
if job == "eight":
    mesh = parse_mesh("4x2")
    for arch, batch in {cases!r}:
        for compress in {compress!r}:
            step(f"4x2-{{arch}}-{{compress}}", get_cfg("tiny:" + arch), mesh,
                 batch, compress)
if job == "two":
    mesh = parse_mesh("1x2")
    step("qknorm-1x2", get_cfg("tiny:qwen3-8b").replace(fsdp_only=False),
         mesh, 8, "none")
    for arch, _ in {cases!r}:
        prefill(f"prefill-1x2-{{arch}}", get_cfg("tiny:" + arch), mesh)
    for arch in {archs!r}:
        decode("decode-1x2-" + arch, get_cfg("tiny:" + arch), mesh,
               {dbatch})
    for arch in {split2!r}:
        sp_prefill("split-1x2-" + arch, get_cfg("tiny:" + arch), mesh)
    sp_prefill("split-capacity", get_cfg("tiny:granite-moe-1b-a400m")
               .replace(moe_capacity_factor={capacity}), mesh)
    text = StringIO()
    with redirect_stdout(text):
        train.main(["--arch", "tiny:qwen2.5-32b", "--mesh", "1x2",
                    "--device", "cpu", "--steps", "{cli_steps}", "--batch",
                    "16", "--seq", "{seq}"])
    if rank == 0:
        with open(os.path.join(out, "cli.txt"), "w") as f:
            f.write(text.getvalue())
dist.destroy_process_group()
'''


def run_job(tmp: Path, job: str, world: int, timeout: int) -> Path:
    """Run ``job`` on ``world`` ranks (one process each); its outputs land
    in the returned directory."""
    out = tmp / job
    out.mkdir()
    script = tmp / f"{job}_worker.py"
    script.write_text(WORKER.format(
        src=SRC, cases=CASES, compress=COMPRESS, seq=SEQ, uneven=UNEVEN,
        batch=PREFILL["batch"], pseq=PREFILL["seq"], pseed=PREFILL["seed"],
        cli_steps=CLI_STEPS, eps=EPS, dprompt=DECODE["prompt"],
        dmax=DECODE["max_len"], dsteps=DECODE["steps"],
        dseed=DECODE["seed"], dbatch=DECODE["batch"], archs=ARCHS,
        decode4=DECODE_1X4, decode22=DECODE_2X2, split2=FSDP_ONLY,
        split4=SPLIT_1X4, capacity=CAPACITY))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp / f"{job}_rdv"), str(out), job], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-2000:] for log in logs)
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return {"four": run_job(tmp, "four", 4, 400),
            "eight": run_job(tmp, "eight", 8, 300),
            "two": run_job(tmp, "two", 2, 200)}


def result(jobs, name: str):
    for d in jobs.values():
        if (d / f"{name}.pt").exists():
            return torch.load(d / f"{name}.pt")
    raise FileNotFoundError(name)


@lru_cache(maxsize=None)
def one_process(arch: str, batch: int, compress: str, **replace):
    cfg = configs.get_tiny_config(arch)
    if replace:
        cfg = cfg.replace(**replace)
    tr = train.Trainer(cfg, lr=LR, eps=EPS, compress=compress, seed=0,
                       device="cpu")
    losses = tr.run(1, batch, SEQ, seed=0, log=lambda *a: None)
    return losses, leaves(tr.params), leaves(tr.opt.m)


def assert_step_equal(got, want, grads: bool):
    losses, params, m = want
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert len(got["params"]) == len(params) == len(got["m"]) == len(m)
    for a, b in zip(got["params"], params):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    # int8 may flip a rank's rounding by one step of 1/127 of its row's
    # largest on a last-ulp change of its partial: the params hold it
    for a, b in zip(got["m"], m) if grads else ():
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("compress", COMPRESS)
@pytest.mark.parametrize("arch,batch", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_matches_one_process(jobs, mesh, arch, batch, compress):
    assert_step_equal(result(jobs, f"{mesh}-{arch}-{compress}"),
                      one_process(arch, batch, compress),
                      grads=compress == "none")


@pytest.mark.parametrize("heads", sorted(UNEVEN))
def test_uneven_heads_step_matches_one_process(jobs, heads):
    """2.5 q heads and half a KV head of columns a rank (1 x 4); with 5 KV
    heads rank 1's q heads straddle two KV groups."""
    split = [A.head_split(10, UNEVEN[heads]["n_kv_heads"], 4, r)
             for r in range(4)]
    repeats = [A._kv_rows(*s, 10 // UNEVEN[heads]["n_kv_heads"])
               for s in split]
    assert any(r is not None for r in repeats) == (heads == "10-5")
    assert_step_equal(result(jobs, "uneven-" + heads),
                      one_process("qwen2.5-32b", 16, "none",
                                  **UNEVEN[heads]), grads=True)


def test_qk_norm_step_matches_one_process(jobs):
    """Tiny qwen3-8b (qk-norm) under the FSDP x TP rules on 1 x 2: each rank
    normalizes its own heads with the replicated ``q_norm`` / ``k_norm``,
    whose gradient is the sum of the ranks' parts."""
    assert_step_equal(result(jobs, "qknorm-1x2"),
                      one_process("qwen3-8b", 8, "none", fsdp_only=False),
                      grads=True)


def test_rank_flops_are_a_quarter_on_four_model_ranks(jobs):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = configs.get_tiny_config("qwen2.5-32b")
    params = MD.init_params(0, cfg, device="cpu")
    hb = SyntheticLM(cfg, 16, SEQ, seed=0, device="cpu").host_batch(0)
    rows = 16 // cfg.grad_accum                   # the first microbatch
    mb = {k: torch.from_numpy(v[:rows]) for k, v in hb.items()}
    with FlopCounterMode(display=False) as fc:
        steps.value_and_grad(params, cfg, mb)
    rank0 = result(jobs, "flops")["rank0"]
    ratio = rank0 / fc.get_total_flops()
    assert 0 < ratio <= FLOP_BOUND, ratio


@pytest.mark.parametrize("shape", ["1x4", "4x1"])
def test_elastic_restart_of_a_tp_run(jobs, shape):
    got = result(jobs, "elastic")
    ref, after = got["ref"], got["got"][shape]
    assert len(ref) == 8 and len(after) == 4
    np.testing.assert_allclose(after, ref[4:], rtol=1e-5)


@lru_cache(maxsize=None)
def one_process_prefill(arch: str):
    cfg = configs.get_tiny_config(arch)
    params = MD.init_params(0, cfg, device="cpu")
    b = MD.dummy_batch(cfg, PREFILL["batch"], PREFILL["seq"], kind="prefill",
                       gen=PREFILL["seed"], device="cpu")
    with torch.inference_mode():
        return MD.apply_prefill(params, cfg, b)


def close(a, b, what: str):
    scale = float(b.abs().max()) or 1.0
    err = float((a.float() - b.float()).abs().max())
    assert err <= 1e-5 * scale, f"{what}: {err} of scale {scale}"


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_tp_prefill_matches_one_process(jobs, shape, arch):
    got = result(jobs, f"prefill-{shape}-{arch}")
    logits, cache = one_process_prefill(arch)
    close(got["logits"], logits, "logits")
    assert torch.equal(got["logits"].argmax(-1), logits.argmax(-1))
    for i, (a, b) in enumerate(zip(got["cache"], cache, strict=True)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, (i, k)
            close(a[k], b[k], f"layer {i} {k}")


def assert_cache_close(got, want):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, (i, k)
            close(a[k], b[k], f"layer {i} {k}")


@lru_cache(maxsize=None)
def one_process_decode(arch: str, B: int, replace: tuple = ()):
    """The worker's ``decode`` in one process: each step's logits and the
    cache at the end."""
    cfg = configs.get_tiny_config(arch).replace(**dict(replace))
    params = MD.init_params(0, cfg, device="cpu")
    b = MD.dummy_batch(cfg, B, DECODE["prompt"], kind="prefill",
                       gen=DECODE["seed"], device="cpu")
    logits = []
    with torch.inference_mode():
        _, cache = MD.apply_prefill(params, cfg, b,
                                    max_len=DECODE["max_len"])
        for t in range(DECODE["steps"]):
            tb = MD.dummy_batch(cfg, B, 1, kind="prefill",
                                gen=DECODE["seed"] + 1 + t, device="cpu")
            lg, cache = MD.apply_decode(params, cfg, cache, tb,
                                        DECODE["prompt"] + t)
            logits.append(lg)
    return logits, cache


DECODE_CASES = ([("decode-1x2-" + a, a, DECODE["batch"], ())
                 for a in ARCHS]
                + [("decode-1x4-" + tag, arch, DECODE["batch"],
                    tuple(sorted(rep.items())))
                   for tag, (arch, rep) in DECODE_1X4.items()]
                + [(f"decode-2x2-B{B}-{a}", a, B, ()) for a in DECODE_2X2
                   for B in (1, DECODE["batch"])])


@pytest.mark.parametrize("tag,arch,B,replace", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_split_decode_matches_one_process(jobs, tag, arch, B, replace):
    """Decode on the decode rule table (weights tensor-parallel over
    "model") over a cache placed by ``shard_cache`` (the KV sequence over
    "model", or every axis at B 1; the scans' states by feature): every
    step's logits and the cache after three steps, gathered, within 1e-5
    of their scale of one process's."""
    got = result(jobs, tag)
    logits, cache = one_process_decode(arch, B, replace)
    assert len(got["logits"]) == len(logits) == DECODE["steps"]
    for a, b in zip(got["logits"], logits):
        assert a.shape == b.shape
        close(a, b, "logits")
    assert_cache_close(got["cache"], cache)


@pytest.mark.parametrize("tag,arch", [("split-1x2-" + a, a)
                                      for a in FSDP_ONLY]
                         + [("split-1x4-" + a, a) for a in SPLIT_1X4])
def test_sequence_split_prefill_matches_one_process(jobs, tag, arch):
    """The fsdp_only configs' prefill with the batch's sequence over
    "model" (replicated weights): the last logits, and the cache gathered
    (KV over the ranks' positions, the RWKV states and last tokens the
    sequence's end), within 1e-5 of their scale of one process's."""
    got = result(jobs, tag)
    logits, cache = one_process_prefill(arch)
    close(got["logits"], logits, "logits")
    assert torch.equal(got["logits"].argmax(-1), logits.argmax(-1))
    assert_cache_close(got["cache"], cache)


def test_sequence_split_prefill_keeps_the_whole_rows_capacity(jobs):
    """Tiny granite with its capacity factor lowered: one process drops
    entries (capacity is the whole row's, C = capacity(S)); the prefill
    split over two ranks drops exactly the same (row, position, expert)
    entries and equals the one-process prefill."""
    from repro_torch.models import moe as X
    cfg = configs.get_tiny_config("granite-moe-1b-a400m").replace(
        moe_capacity_factor=CAPACITY)
    drops = []
    dispatch = X._group_dispatch

    def record(x, gates, idx, E, C, *rest):
        out = dispatch(x, gates, idx, E, C, *rest)
        e = torch.sort(idx.reshape(idx.shape[0], -1), stable=True)[0]
        drops.extend((int(g), int(out[3][g, j]), int(e[g, j]))
                     for g, j in (~out[2]).nonzero().tolist())
        return out
    params = MD.init_params(0, cfg, device="cpu")
    b = MD.dummy_batch(cfg, PREFILL["batch"], PREFILL["seq"], kind="prefill",
                       gen=PREFILL["seed"], device="cpu")
    X._group_dispatch = record
    try:
        with torch.inference_mode():
            logits, cache = MD.apply_prefill(params, cfg, b)
    finally:
        X._group_dispatch = dispatch
    got = result(jobs, "split-capacity")
    assert drops, "the one-process prefill drops no entry"
    assert got["drops"] == sorted(drops)
    close(got["logits"], logits, "logits")
    assert_cache_close(got["cache"], cache)


def test_cli_on_two_model_ranks_matches_one_process(jobs):
    text = (jobs["two"] / "cli.txt").read_text()
    last = float(re.search(r"last loss ([0-9.]+)", text).group(1))
    tr = train.Trainer(configs.get_tiny_config("qwen2.5-32b"), seed=0,
                       device="cpu")
    want = tr.run(CLI_STEPS, 16, SEQ, seed=0, log=lambda *a: None)[-1]
    np.testing.assert_allclose(last, want, rtol=1e-5)


# ------------------------------------------------ head and channel plans --
def test_head_split_of_the_production_configs_needs_no_kv_repeat():
    """At 16 ranks every rank's q heads read one KV head or whole groups:
    qwen2.5-32b 2 or 3 heads (rank pairs share a KV head), grok-1 3,
    jamba 2; at 2 ranks each rank holds whole groups."""
    for arch, n, sizes in (("qwen2.5-32b", 16, {2, 3}),
                           ("grok-1-314b", 16, {3}),
                           ("jamba-v0.1-52b", 16, {2}),
                           ("qwen2.5-32b", 2, {20}),
                           ("grok-1-314b", 2, {24})):
        cfg = configs.get_config(arch)
        H, Kv = cfg.n_heads, cfg.n_kv_heads
        split = [A.head_split(H, Kv, n, r) for r in range(n)]
        assert [s[0] for s in split[1:]] == [s[1] for s in split[:-1]]
        assert split[0][0] == 0 and split[-1][1] == H
        assert {b - a for a, b, _, _ in split} == sizes
        for a, b, ka, kb in split:
            assert A._kv_rows(a, b, ka, kb, H // Kv) is None


def test_exchange_plan_pairs_mamba_x_and_z_channels():
    """in_proj's 2 di columns split contiguously: at tp 2 rank 0 holds all
    of x and rank 1 all of z; the plan sends each rank x's and z's columns
    of its channel block, and a rank that wants what it has sends
    nothing."""
    di, n = 8, 2
    want = tuple(((lo, hi), (di + lo, di + hi))
                 for lo, hi in pctx.shards(di, n))
    have = tuple(pctx.shards(2 * di, n))
    idx0, send0, recv0 = pctx.exchange_plan(have, want, 0)
    assert send0 == [4, 4] and recv0 == [4, 4]
    assert list(idx0) == [0, 1, 2, 3, 4, 5, 6, 7]   # x's c_0, then x's c_1
    idx1, send1, recv1 = pctx.exchange_plan(have, want, 1)
    assert list(idx1) == [0, 1, 2, 3, 4, 5, 6, 7]   # z's c_0, then z's c_1
    assert pctx.exchange_plan(have, tuple((h,) for h in have), 0) is None


def test_words_view_aliases_a_column_of_one_row():
    """A prefill's logits of one row, moved to dim 0 for the gather, are
    (V / tp, 1) with a last stride of V / tp: the byte view that moves
    bf16 through gloo takes it through its flat view and writes through
    to it."""
    x = torch.randn(1, 12).to(torch.bfloat16).movedim(-1, 0).contiguous()
    assert x.stride(-1) != 1
    words = pctx._words(x)
    assert words.dtype == torch.uint8 and words.shape == (12, 2)
    words.zero_()
    assert not x.float().abs().sum()
