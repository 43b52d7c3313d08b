"""The port's training substrate held against the JAX package, on the CPU:
AdamW, error-feedback compression, the synthetic data stream and
checkpoints.

Inputs are drawn with numpy from a seed and fed to both packages.
Tolerances, each with its reason:
  - AdamW: ``rtol=1e-6`` on params and f32 moments (the same f32 formula;
    PyTorch fuses ``m * b1 + (1 - b1) * g`` into one rounding where XLA
    rounds twice, a few ulp after three steps); bf16 moments within one
    bf16 rounding (a one-ulp f32 difference may round the other way);
  - int8 compression in f32: bit for bit (``sent`` and the EF buffers), the
    quantize math being exact on both sides; ``compress_err`` (a sum of
    squares in another order) ``rtol=1e-6``;
  - top-k: exact on inputs without ties in |x| (``torch.topk`` and
    ``lax.top_k`` may order ties differently);
  - data: the tokens and labels are equal, drawn by the same numpy
    generator from (seed, step).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import pack_documents as j_pack
from repro.optim import adamw as jadamw
from repro.optim.compress import GradCompressor as JGradCompressor

from repro_torch import configs
from repro_torch._tree import leaves, map_tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import Prefetcher, SyntheticLM, pack_documents
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor

CPU = "cpu"


def np_tree(rng, scale=1.0):
    """A small list-of-layers parameter tree of numpy f32 leaves."""
    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": {"table": n(10, 8)},
            "layers": [{"w": n(8, 8), "g": n(8)}, {"w": n(8, 8), "g": n(8)}],
            "head": {"w": n(8, 10)}}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_tree(t, j, **tol):
    tl, jl = leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        if tol:
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)


# ================================================================= adamw ====
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_three_steps_match_jax(moments):
    rng = np.random.default_rng(0)
    params = np_tree(rng)
    tp, jp = to_torch(params), to_jax(params)
    to, jo = adamw.init(tp, moments), jadamw.init(jp, moments)
    for step in range(3):
        g = np_tree(rng, scale=0.3)     # global norm > 1: the clip is live
        tp, to, tm = adamw.update(to_torch(g), to, tp, lr=1e-2)
        jp, jo, jm = jadamw.update(to_jax(g), jo, jp, lr=1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(jm["grad_norm"]) > 1.0
        assert_tree(tp, jp, rtol=1e-6, atol=1e-7)
        mom = dict(rtol=1e-6, atol=1e-7) if moments == "float32" else \
            dict(rtol=2 ** -7, atol=1e-7)
        assert_tree(to.m, jo.m, **mom)
        assert_tree(to.v, jo.v, **mom)
        assert int(to.count) == int(jo.count) == step + 1
        assert leaves(to.m)[0].dtype == getattr(torch, moments)


def test_adamw_updates_in_place_and_converges():
    """The JAX package's quadratic: 200 steps drive sum(p^2) below 1e-2."""
    params = {"layers": [{"w": torch.ones(4) * 5}], "head": {"w":
                                                            torch.ones(4) * 5}}
    ids = [id(t) for t in leaves(params)]
    opt = adamw.init(params)
    for _ in range(200):
        g = map_tree(lambda x: 2 * x, params)
        params, opt, _ = adamw.update(g, opt, params, lr=0.1,
                                      weight_decay=0.0)
    assert [id(t) for t in leaves(params)] == ids
    assert sum(float((x ** 2).sum()) for x in leaves(params)) < 1e-2


def test_grad_clipping_reports_the_norm_before_the_clip():
    p, jp = {"w": torch.ones(4)}, {"w": jnp.ones(4)}
    g = np.full(4, 1e6, np.float32)
    tp, _, tm = adamw.update({"w": torch.from_numpy(g)}, adamw.init(p), p,
                             lr=0.1, clip_norm=1.0)
    jp, _, jm = jadamw.update({"w": jnp.asarray(g)}, jadamw.init(jp), jp,
                              lr=0.1, clip_norm=1.0)
    assert float(tm["grad_norm"]) > 1e5
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 10, 100, 55])
def test_cosine_schedule_matches_jax(step):
    got = adamw.cosine_schedule(1.0, warmup=10, total=100)(step)
    want = jadamw.cosine_schedule(1.0, warmup=10, total=100)(jnp.int32(step))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if step == 100:
        assert float(got) == pytest.approx(0.1, abs=1e-3)


# ============================================================ compression ====
@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressor_five_steps_with_error_feedback_match_jax(method):
    rng = np.random.default_rng(1)
    tc, jc = GradCompressor(method, 0.25), JGradCompressor(method, 0.25)
    grads = np_tree(rng)
    tef, jef = tc.init(to_torch(grads)), jc.init(to_jax(grads))
    for step in range(5):
        g = np_tree(rng, scale=10.0 ** (step - 2))
        tsent, tef, tm = tc.compress(to_torch(g), tef)
        jsent, jef, jm = jc.compress(to_jax(g), jef)
        assert_tree(tsent, jsent)
        assert_tree(tef, jef)
        np.testing.assert_allclose(float(tm["compress_err"]),
                                   float(jm["compress_err"]), rtol=1e-6)


def test_compressor_none_passes_grads_through():
    g = to_torch(np_tree(np.random.default_rng(2)))
    c = GradCompressor("none")
    assert c.init(g) is None
    sent, ef, m = c.compress(g, None)
    assert sent is g and ef is None and float(m["compress_err"]) == 0.0


def test_int8_roundtrip_and_error_feedback_accumulate():
    """The JAX package's two compression properties, replayed: the int8
    round trip is within half a quantum, and top-k with EF sends the true
    gradient's mass over 40 steps (as the JAX class does, to 1e-5)."""
    from repro_torch.optim.compress import dequant_int8, quant_int8
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 256)).astype(np.float32))
    q, s = quant_int8(x)
    assert float((dequant_int8(q, s) - x).abs().max()) < float(s.max()) * 0.51
    g = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    comp, jcomp = GradCompressor("topk", 0.25), JGradCompressor("topk", 0.25)
    ef, jef = comp.init({"w": torch.zeros(64)}), jcomp.init({"w": g})
    total, jtotal = torch.zeros(64), jnp.zeros(64)
    for _ in range(40):
        sent, ef, _ = comp.compress({"w": torch.from_numpy(g)}, ef)
        jsent, jef, _ = jcomp.compress({"w": jnp.asarray(g)}, jef)
        total, jtotal = total + sent["w"], jtotal + jsent["w"]
    rel = float(np.linalg.norm(total.numpy() - g * 40) /
                np.linalg.norm(g * 40))
    assert rel < 0.05, rel
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=1e-5,
                               atol=1e-5)


def test_wire_ratio():
    for method, k in (("int8", 0.05), ("topk", 0.05), ("none", 0.05)):
        assert GradCompressor(method, k).wire_bytes_ratio() == \
            JGradCompressor(method, k).wire_bytes_ratio()
    assert GradCompressor("int8").wire_bytes_ratio() == 0.25
    assert GradCompressor("topk", 0.05).wire_bytes_ratio() == 0.1


# =================================================================== data ====
@pytest.mark.parametrize("arch", ["yi-6b", "musicgen-medium"])
def test_synthetic_lm_draws_the_jax_packages_batches(arch):
    cfg, jcfg = configs.get_tiny_config(arch), jconfigs.get_tiny_config(arch)
    for seed, step in ((0, 0), (1, 17), (7, 3)):
        got = SyntheticLM(cfg, 4, 32, seed=seed, device=CPU).batch(step)
        want = JSyntheticLM(jcfg, 4, 32, seed=seed).batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    d = SyntheticLM(cfg, 4, 32, seed=1, device=CPU)
    assert not torch.equal(d.batch(17)[next(iter(want))],
                           d.batch(18)[next(iter(want))])


def test_stream_is_step_indexed():
    d = SyntheticLM(configs.get_tiny_config("yi-6b"), 2, 16, seed=2,
                    device=CPU)
    it = d.stream(start_step=5)
    for step in (5, 6, 7):
        assert torch.equal(next(it)["tokens"], d.batch(step)["tokens"])


def test_packing_matches_jax():
    docs = [np.arange(2, 7), np.arange(10, 13), np.arange(20, 30)]
    rows = pack_documents(docs, S=8, eos_id=1)
    np.testing.assert_array_equal(rows, j_pack(docs, S=8, eos_id=1))
    assert rows.shape[1] == 8
    total = sum(len(d) for d in docs) + len(docs)
    assert (rows.reshape(-1) != 0).sum() >= total - 1


def test_prefetcher():
    assert list(Prefetcher(iter(range(10)), depth=2)) == list(range(10))
    p = Prefetcher(iter(range(1000)), depth=2)
    assert next(p) == 0
    p.close()


# ============================================================= checkpoint ====
def test_atomic_save_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4)]}
    mgr.save(1, tree, extra={"step": 1}, block=True)
    restored, extra = mgr.restore(None, map_tree(lambda x: x * 0, tree))
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"][0], tree["b"][0])
    assert extra["step"] == 1


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.ones(2)}, block=True)
    assert mgr.steps() == [3, 4]


def test_corrupt_tmp_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    t = {"a": torch.ones(2)}
    mgr.save(5, t, block=True)
    (tmp_path / "step_9.tmp").mkdir()     # simulated mid-crash leftover
    assert mgr.latest_step() == 5
    mgr.restore(None, t)
    CheckpointManager(tmp_path)           # the sweep drops the .tmp
    assert not (tmp_path / "step_9.tmp").exists()


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(2)}, block=True)
    with pytest.raises(AssertionError):
        mgr.restore(None, {"a": torch.ones(3)})


def test_bf16_leaves_and_optimizer_state_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    params = map_tree(lambda x: x.to(torch.bfloat16), to_torch(np_tree(rng)))
    opt = adamw.init(params, "bfloat16")
    opt = opt._replace(count=opt.count + 3)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"params": params, "opt": opt}, extra={"step": 3}, block=True)
    like = {"params": map_tree(torch.zeros_like, params),
            "opt": adamw.init(params, "bfloat16")}
    got, extra = mgr.restore(3, like)
    assert isinstance(got["opt"], adamw.AdamWState) and extra == {"step": 3}
    assert int(got["opt"].count) == 3
    for a, b in zip(leaves(got["params"]), leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_old_copy_is_promoted_back_after_a_torn_publish(tmp_path):
    """A crash between rename-aside and publish leaves ``step_N.old`` and
    a torn ``step_N``: the sweep restores the old copy, as the JAX
    manager's does."""
    t = {"a": torch.arange(3.0)}
    CheckpointManager(tmp_path).save(2, t, block=True)
    jt = {"a": jnp.arange(3.0)}
    JCheckpointManager(tmp_path / "j").save(2, jt, block=True)
    for root in (tmp_path, tmp_path / "j"):
        (root / "step_2").rename(root / "step_2.old")
        (root / "step_2").mkdir()                      # torn: no meta
    mgr = CheckpointManager(tmp_path)
    JCheckpointManager(tmp_path / "j")
    assert mgr.steps() == [2] and (tmp_path / "j" / "step_2").exists()
    assert torch.equal(mgr.restore(2, t)[0]["a"], t["a"])
