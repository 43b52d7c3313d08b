"""The port's sharded Trainer, elastic checkpoints and compressed
all-reduces over ``torch.distributed`` on the CPU (gloo), held against the
port's one-process step and the JAX package.

Each multi-process job runs its ranks as separate processes of one script
(written to ``tmp_path``), rendezvous through a ``file://`` store in
``tmp_path`` (never a fixed port: files run at once under xdist), with a
60 s process-group timeout, one thread a rank and a timeout on the whole
job.  Expectations, each the port's own (the JAX package's sharded tests
are red here, so none is copied from them):
  - a step of the sharded Trainer on a 4 x 2 mesh (tiny yi-6b and granite
    with ``fsdp_only``, tiny jamba with the FSDP x TP rules and
    ``moe_ep``), without and with int8 compression, equals the one-process
    Trainer's step: the loss within 1e-5 relative, the params within 1e-5
    (at the default lr 3e-4 and Adam eps 1e-6: the first Adam step is
    about g / (|g| + eps), so at the default eps 1e-8 an element whose
    gradient lies within a few eps of zero moves by up to lr on a last-ulp
    change of the reduction order, which tiny Jamba's tensor-parallel sums
    make; at 1e-6 a gradient difference moves the step by at most lr / eps
    = 300 times itself), and the first moment (0.1 of the clipped
    gradient) within 1e-5 of each leaf's largest without compression (with
    int8 a last-ulp change of a rank's partial may flip its rounding by one
    step of 1/127 of the row's largest, which the params hold);
  - the one-process step of granite and jamba equals the JAX package's
    jitted ``make_train_step`` within the train gates of
    ``tests/test_torch_train.py`` (yi-6b's is held there), plus, per
    element, what the gradient gate's 1e-5 of the leaf's largest |g| moves
    the first Adam step at that element's |g| (lr eps dg / (|g| + eps)^2:
    an element within a few eps of zero may move by up to lr);
  - a run saved at step 4 on 2 x 2 and restored on 4 x 1 or 1 x 4 ends
    step 8 with the uninterrupted 2 x 2 run's loss within 1e-5 relative;
  - ``compressed_psum_int8`` / ``_topk`` over a group of 4 equal the sum
    over ranks of the JAX package's ``quant_int8`` -> ``dequant_int8``
    (``topk_sparsify`` -> ``topk_densify``) of each rank's input.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim.compress import dequant_int8 as jdequant
from repro.optim.compress import quant_int8 as jquant
from repro.optim.compress import topk_densify as jdensify
from repro.optim.compress import topk_sparsify as jsparsify

from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import model_params_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.optim import adamw

SRC = str(Path(__file__).resolve().parents[1] / "src")
SEQ = 32
#: (arch, batch): jamba's batch splits into its 4 microbatches of 4 rows,
#: one a data rank
STEP_CASES = [("yi-6b", 8), ("granite-moe-1b-a400m", 8),
              ("jamba-v0.1-52b", 16)]
COMPRESS = ("none", "int8")
TOPK_FRAC = 0.1
EPS = 1e-6

WORKER = r'''
import json, os, shutil, sys
from datetime import timedelta
rank, world, rdv, out, job = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
from repro_torch._tree import leaves
from repro_torch.launch.train import Trainer, get_cfg, parse_mesh
quiet = dict(log=lambda *a: None)
if job == "steps":
    mesh = parse_mesh("4x2")
    for arch, batch in {cases!r}:
        for compress in {compress!r}:
            tr = Trainer(get_cfg("tiny:" + arch), mesh=mesh,
                         compress=compress, seed=0, eps={eps})
            losses = tr.run(1, batch, {seq}, seed=0, **quiet)
            full = [x.full_tensor() for x in leaves(tr.params)]
            m = [x.full_tensor() for x in leaves(tr.opt.m)]
            if rank == 0:
                torch.save({{"losses": losses, "params": full, "m": m}},
                           os.path.join(out, f"{{arch}}-{{compress}}.pt"))
if job == "elastic":
    cfg = get_cfg("tiny:yi-6b")
    ref = Trainer(cfg, mesh=parse_mesh("2x2"), seed=0).run(8, 8, {seq},
                                                           **quiet)
    ck = os.path.join(out, "ck")
    tr = Trainer(cfg, ck, mesh=parse_mesh("2x2"), seed=0)
    try:
        tr.run(8, 8, {seq}, ckpt_every=4, crash_at=4, **quiet)
    except RuntimeError:
        pass
    if rank == 0:
        shutil.copytree(ck, ck + "2")
    dist.barrier()
    got = {{}}
    for shape, d in (("4x1", ck), ("1x4", ck + "2")):
        tr = Trainer(cfg, d, mesh=parse_mesh(shape), seed=1)
        assert tr.restore_if_any() and tr.step == 4
        got[shape] = tr.run(8, 8, {seq}, ckpt_every=100, **quiet)
    from repro_torch.optim.compress import (compressed_psum_int8,
                                            compressed_psum_topk)
    psum = {{}}
    for name, shape in (("2d", (6, 33)), ("3d", (2, 3, 11))):
        x = np.random.default_rng((7, rank)).standard_normal(
            shape).astype(np.float32)
        psum["int8-" + name] = compressed_psum_int8(
            torch.from_numpy(x)).tolist()
        psum["topk-" + name] = compressed_psum_topk(
            torch.from_numpy(x), k_frac={topk}).tolist()
    if rank == 0:
        with open(os.path.join(out, "elastic.json"), "w") as f:
            json.dump({{"ref": ref, "got": got, "psum": psum}}, f)
dist.destroy_process_group()
'''


def run_job(tmp: Path, job: str, world: int, timeout: int) -> Path:
    """Run ``job`` on ``world`` ranks (one process each); its outputs land
    in the returned directory."""
    out = tmp / job
    out.mkdir()
    script = tmp / f"{job}_worker.py"
    script.write_text(WORKER.format(src=SRC, cases=STEP_CASES,
                                    compress=COMPRESS, seq=SEQ,
                                    topk=TOPK_FRAC, eps=EPS))
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
def step_runs(tmp_path_factory):
    return run_job(tmp_path_factory.mktemp("mesh"), "steps", 8, 300)


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    out = run_job(tmp_path_factory.mktemp("mesh"), "elastic", 4, 300)
    return json.loads((out / "elastic.json").read_text())


@lru_cache(maxsize=None)
def one_process(arch: str, batch: int, compress: str):
    tr = train.Trainer(configs.get_tiny_config(arch), compress=compress,
                       seed=0, eps=EPS, device="cpu")
    losses = tr.run(1, batch, SEQ, seed=0, log=lambda *a: None)
    return losses, leaves(tr.params), leaves(tr.opt.m)


@pytest.mark.parametrize("compress", COMPRESS)
@pytest.mark.parametrize("arch,batch", STEP_CASES)
def test_sharded_step_matches_one_process(step_runs, arch, batch, compress):
    got = torch.load(step_runs / f"{arch}-{compress}.pt")
    losses, params, _ = one_process(arch, batch, compress)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert len(got["params"]) == len(params)
    for a, b in zip(got["params"], params):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,batch", STEP_CASES)
def test_sharded_grads_match_one_process(step_runs, arch, batch):
    """The first moment, 0.1 of the clipped gradient, of the sharded step
    against the one-process step's, leaf by leaf within 1e-5 of its
    largest."""
    got = torch.load(step_runs / f"{arch}-none.pt")
    _, _, m = one_process(arch, batch, "none")
    assert len(got["m"]) == len(m)
    for a, b in zip(got["m"], m):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("arch,batch", STEP_CASES[1:])
def test_one_process_step_matches_jax(arch, batch):
    """The tiny MoE and hybrid configs' train step (its grad_accum) against
    the JAX package's jitted ``make_train_step`` on the same weights and
    batch (``tests/test_torch_train.py``'s gates)."""
    cfg = jconfigs.get_tiny_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(5), cfg)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                 configs.get_tiny_config(arch), "cpu")
    hb = SyntheticLM(configs.get_tiny_config(arch), batch, SEQ, seed=3,
                     device="cpu").host_batch(0)
    lr = 1e-3
    jp, jo, jm = jax.jit(jsteps.make_train_step(cfg, lr=lr))(
        jp, jadamw.init(jp), hb)
    tstep = steps.make_train_step(configs.get_tiny_config(arch), lr=lr)
    tp, _, tm = tstep(tp, adamw.init(tp, "float32"),
                      {k: torch.from_numpy(v) for k, v in hb.items()})
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    # the first Adam step is g / (|g| + eps), so a gradient difference dg
    # moves an element by lr eps dg / (|g| + eps)^2: with dg at the
    # gradient gate of tests/test_torch_train.py (1e-5 of the leaf's
    # largest |g|; |g| = sqrt(v / (1 - b2)) from the JAX state) that is
    # added to the step gate (tiny jamba: one element of layers[1].attn.wv,
    # |g| 3.0e-8, moves 6.4 % of lr)
    eps = 1e-8
    for a, b, v in zip(leaves(tp), jax.tree.leaves(jp),
                       jax.tree.leaves(jo.v)):
        g = np.sqrt(np.asarray(v, np.float64) / (1 - 0.95))
        b = np.asarray(b, np.float64)
        cond = lr * np.minimum(1.0, eps * 1e-5 * g.max() / (g + eps) ** 2)
        tol = 1e-5 * np.abs(b) + 5e-2 * lr + cond
        assert (np.abs(a.numpy() - b) <= tol).all(), \
            float((np.abs(a.numpy() - b) - tol).max())


@pytest.mark.parametrize("shape", ["4x1", "1x4"])
def test_elastic_restart_on_another_mesh(elastic_runs, shape):
    ref, got = elastic_runs["ref"], elastic_runs["got"][shape]
    assert len(ref) == 8 and len(got) == 4
    np.testing.assert_allclose(got, ref[4:], rtol=1e-5)


def rank_inputs(shape):
    return [np.random.default_rng((7, r)).standard_normal(shape).astype(
        np.float32) for r in range(4)]


@pytest.mark.parametrize("name,shape", [("2d", (6, 33)), ("3d", (2, 3, 11))])
def test_compressed_psum_int8_is_the_sum_of_jax_round_trips(elastic_runs,
                                                            name, shape):
    """Per row of a 2-d input, one row of anything else, as the JAX
    package's ``compressed_psum_int8``."""
    want = 0
    for x in rank_inputs(shape):
        rows = x if x.ndim == 2 else x.reshape(1, -1)
        q, s = jquant(rows)
        want = want + np.asarray(jdequant(q, s)).reshape(shape)
    np.testing.assert_allclose(np.asarray(elastic_runs["psum"][
        "int8-" + name]), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,shape", [("2d", (6, 33)), ("3d", (2, 3, 11))])
def test_compressed_psum_topk_is_the_sum_of_jax_round_trips(elastic_runs,
                                                            name, shape):
    want = 0
    for x in rank_inputs(shape):
        vals, idx, n = jsparsify(x, TOPK_FRAC)
        want = want + np.asarray(jdensify(vals, idx, n, shape))
    np.testing.assert_allclose(np.asarray(elastic_runs["psum"][
        "topk-" + name]), want, rtol=1e-6, atol=1e-6)


def test_place_microbatches_splits_as_the_jax_package():
    """The global batch's rows split into microbatches first, then each
    placed by ``batch_specs``; the most microbatches that divide over the
    batch ranks; the batch repeated over the major axes it does not
    divide over."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.data import place_microbatches
    from repro_torch.launch.mesh import make_mesh

    b = {"tokens": np.arange(32 * 4, dtype=np.int32).reshape(32, 4)}
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=5,
                            world_size=8)
    try:
        mesh = make_mesh((4, 2))                    # rank 5: (2, 1)
        micro = place_microbatches(b, 4, mesh)      # 8 rows over data 4
        assert len(micro) == 4
        for i, mb in enumerate(micro):
            np.testing.assert_array_equal(mb["tokens"].numpy(),
                                          b["tokens"][8 * i + 4:8 * i + 6])
        micro = place_microbatches(b, 8, mesh, all_axes=True)  # 4 < 8 rows
        assert len(micro) == 4                      # 4 x 8 rows, 1 a rank
        np.testing.assert_array_equal(micro[1]["tokens"].numpy(),
                                      b["tokens"][13:14])
        one = place_microbatches({"t": b["tokens"][:2]}, 1, mesh,
                                 all_axes=True)     # 2 rows over 8 ranks
        np.testing.assert_array_equal(one[0]["t"].numpy(),
                                      b["tokens"][1:2])   # over "model"
    finally:
        dist.destroy_process_group()


def test_mesh_larger_than_the_group_raises():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh, make_test_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((2, 2))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(ValueError, match="needs 8 ranks"):
            make_mesh((4, 2))
        mesh = make_test_mesh(2, 2)
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.device_type == "cpu"
        assert train.parse_mesh("1x4").mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="DxM"):
            train.parse_mesh("4")
    finally:
        dist.destroy_process_group()
