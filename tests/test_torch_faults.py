"""The PyTorch port's fault plane and compute fleet held against the JAX
package's.

``FaultPlan`` builders, validation and fingerprints (which must equal the
JAX package's for the same plan), the seeded ``FaultState`` gate, and the
compute cases of ``tests/test_faults.py`` (``TestComputeFailover`` and the
compute fleet of ``TestFaultInvariants``) run on both packages
(``device="cpu"`` for the port): outputs compare exactly and the fleet
reports (failovers, replays, losses, routes, retries) must be equal.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.api as japi
import repro.faults as jfaults
from repro.analysis import invariants as jinv
from repro.serving import vpc as jvpc

import repro_torch.api as tapi
import repro_torch.faults as tfaults
from repro_torch.analysis import invariants as tinv
from repro_torch.convert import params_from_numpy

API = {"jax": japi, "torch": tapi}
FAULTS = {"jax": jfaults, "torch": tfaults}
INV = {"jax": jinv, "torch": tinv}
PKGS = tuple(API)

RULES = tuple(np.array(x) for x in jvpc.make_rules(32, seed=2))
KEY = np.arange(8, dtype=np.uint32) * 3 + 1
NONCE = np.arange(3, dtype=np.uint32) + 7


def chacha_params(pkg):
    """``tests/test_faults.py``'s stateful chain params (stream-mode ChaCha
    counter) in the package's arrays."""
    p = {"firewall": {"rules": RULES},
         "chacha20": {"stream": True, "key": KEY, "nonce": NONCE,
                      "counter0": 1}}
    if pkg == "torch":
        return params_from_numpy(p, "cpu")
    return {"firewall": {"rules": tuple(jnp.asarray(x) for x in RULES)},
            "chacha20": {**p["chacha20"], "key": jnp.asarray(KEY),
                         "nonce": jnp.asarray(NONCE)}}


def mk_batch(i, n=8):
    rng = np.random.default_rng(100 + i)
    return {"headers": rng.integers(0, 2 ** 31, (n, 5), dtype=np.uint32),
            "payload": rng.integers(0, 2 ** 31, (n, 16), dtype=np.uint32)}


def fleet(pkg, n, plan=None, **kw):
    """``n`` compute shards ``c0..`` behind a ShardedBackend; tenant ``a``
    deploys ``firewall >> chacha20`` pinned to shard 0."""
    api = API[pkg]
    dev = {"device": "cpu"} if pkg == "torch" else {}
    shards = [api.ComputeBackend(name=f"c{i}", **dev) for i in range(n)]
    kw.setdefault("auto_rebalance", False)
    sb = api.ShardedBackend(shards, fault_plan=plan, **kw)
    plat = api.Platform(sb, specs=api.VPC_SPECS)
    ten = plat.tenant("a", weight=1.0)
    dep = ten.deploy(api.nt("firewall") >> api.nt("chacha20"), shard=0,
                     params=chacha_params(pkg))
    return sb, plat, dep


def fleet_extra(rep) -> dict:
    keys = ("failovers", "replayed", "lost", "routes", "inject_retries",
            "backoff_ns", "shed", "health", "migrations", "recoveries")
    return {k: rep.extra[k] for k in keys}


def payloads(rep, tenant="a"):
    return [np.asarray(o["payload"]) for o in rep.tenants[tenant].outputs]


# ================================================================== plan ====
def build_plan(faults):
    return (faults.FaultPlan(seed=7)
            .crash(shard=2, epoch=40)
            .hang(shard=1, epoch=10, duration=5)
            .degrade(shard=0, epoch=3, factor=0.5, duration=8)
            .drop(shard=3, epoch=0, prob=0.1)
            .add_tenant("e", epoch=12, weight=2.0)
            .remove_tenant("b", epoch=30))


PLANS = {
    "builders": build_plan,
    "crash_drop": lambda f: f.FaultPlan(seed=3).crash(shard=0, epoch=5).drop(
        shard=1, epoch=2, prob=0.1),
    "other_seed": lambda f: f.FaultPlan(seed=4).crash(shard=0, epoch=5),
    "corrupt_nt": lambda f: f.FaultPlan(seed=11).corrupt(
        shard=1, epoch=0, prob=0.25).nt_exception(shard=0, epoch=2,
                                                  nt="nat", duration=3),
    "recover": lambda f: f.FaultPlan(seed=1).crash(shard=0, epoch=1)
    .recover(shard=0, epoch=4),
    "empty": lambda f: f.FaultPlan(),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_fingerprint_and_dict_equal_the_jax_package(name):
    jp, tp = PLANS[name](jfaults), PLANS[name](tfaults)
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.to_dict() == jp.to_dict()
    assert tp.max_epoch == jp.max_epoch
    for e in range(0, 45):
        assert [ev.kind for ev in tp.events_at(e)] == \
            [ev.kind for ev in jp.events_at(e)]
    rt = tfaults.FaultPlan.from_dict(json.loads(json.dumps(tp.to_dict())))
    assert rt.fingerprint() == tp.fingerprint()


def test_builders_and_query():
    for f in (jfaults, tfaults):
        plan = build_plan(f)
        assert len(plan.events) == 6
        assert [e.kind for e in plan.events_at(40)] == ["crash"]
        assert plan.max_epoch == 40


@pytest.mark.parametrize("pkg", PKGS)
def test_validation(pkg):
    f = FAULTS[pkg]
    with pytest.raises(ValueError, match="unknown fault kind"):
        f.FaultEvent(kind="meteor", epoch=1)
    with pytest.raises(ValueError, match="epoch"):
        f.FaultEvent(kind="crash", epoch=-1)
    with pytest.raises(ValueError, match="factor"):
        f.FaultPlan().degrade(shard=0, epoch=0, factor=1.5)


def test_fingerprint_stable_and_roundtrip():
    p1 = PLANS["crash_drop"](tfaults)
    p2 = tfaults.FaultPlan.from_dict(json.loads(json.dumps(p1.to_dict())))
    assert p1.fingerprint() == p2.fingerprint()
    assert p1.fingerprint() != PLANS["other_seed"](tfaults).fingerprint()
    assert p1.fingerprint() == PLANS["crash_drop"](jfaults).fingerprint()


@pytest.mark.parametrize("prob", [0.5, 0.1])
def test_state_gate_is_seeded_and_equal(prob):
    """The drop/corrupt gate draws the same verdicts as the JAX package's
    for the same seed."""
    verdicts = []
    for f in (jfaults, tfaults):
        s = f.FaultState("x", seed=9)
        s.drop_prob = prob
        s.corrupt_prob = prob
        verdicts.append(([s.gate_inject("t") for _ in range(60)],
                         s.drops, s.corrupted))
    assert verdicts[0] == verdicts[1]
    assert "drop" in verdicts[1][0] and "ok" in verdicts[1][0]


@pytest.mark.parametrize("pkg", PKGS)
def test_state_probe_raises(pkg):
    f = FAULTS[pkg]
    st = f.FaultState("x")
    st.check_probe()
    st.crashed = True
    with pytest.raises(f.ShardCrashed):
        st.check_probe()
    assert not st.gate_stream() and st.stream_interrupts == 1
    st.crashed, st.hung = False, True
    with pytest.raises(f.ShardHung):
        st.check_probe()
    st.hung = False
    assert st.gate_stream()
    st.nt_faults.add("nat")
    with pytest.raises(f.NTKernelFault):
        st.gate_inject("t", ("firewall", "nat"))
    assert st.gate_inject("t", ("firewall",)) == "ok"


# ===================================================== compute failover ====
def run_fleet(pkg, crash, ckpt=None):
    plan = FAULTS[pkg].FaultPlan(seed=3).crash(shard=0, epoch=2) if crash \
        else None
    sb, plat, dep = fleet(pkg, 2, plan, health_threshold=1,
                          checkpoint=str(ckpt) if ckpt else None)
    for ep in range(4):
        sb.inject("a", dep.uid, state=mk_batch(ep))
        sb.run()
    rep = plat.report()
    return np.concatenate(payloads(rep)), rep


def test_megakernel_bit_exact_across_crash_recover(tmp_path):
    """The stateful (stream-ctr) chain crashes mid-run, fails over,
    restores its counter from the checkpoint, and the whole output stream
    is bit-identical to the crash-free run and to the JAX package's."""
    got = {}
    for pkg in PKGS:
        ref, _ = run_fleet(pkg, crash=False)
        out, rep = run_fleet(pkg, crash=True, ckpt=tmp_path / pkg / "ckpt")
        (fo,) = rep.extra["failovers"]
        assert fo["shard"] == "c0" and fo["lost"] == []
        assert rep.extra["replayed"] >= 1
        assert rep.extra["lost"]["deployments"] == 0
        np.testing.assert_array_equal(ref, out)
        got[pkg] = (out, fleet_extra(rep))
    np.testing.assert_array_equal(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]


def test_checkpoint_restore_keeps_the_exact_counter(tmp_path):
    """The port's checkpoint plane saves stream counters as int64 CPU
    tensors and restores the exact integer (no u32 narrowing, no float),
    also past 2**32, where the JAX package's restore keeps only the low
    32 bits: the failover target imports what the shard exported, and the
    batches before and after the move have the JAX package's bits (the
    keystream counter is used modulo 2**32)."""
    start = 2 ** 32 - 3                 # the u32 counter wraps in the batch
    got = {}
    for pkg in PKGS:
        sb, plat, dep = fleet(pkg, 2, checkpoint=str(tmp_path / pkg / "ck"))
        sb.shards[0].import_state(dep.uid, {"chacha20": {"next_ctr": start}})
        sb.inject("a", dep.uid, state=mk_batch(0, n=11))
        sb.run()
        want = sb.shards[0].export_state(dep.uid)["chacha20"]["next_ctr"]
        assert want == start + 11
        assert sb.migrate(dep.uid, 1)
        sb._restore_state(dep.uid, 1)
        moved = sb.shards[1].export_state(dep.uid)["chacha20"]["next_ctr"]
        assert moved == (want if pkg == "torch" else want % 2 ** 32)
        sb.inject("a", dep.uid, state=mk_batch(1, n=9))
        sb.run()
        got[pkg] = payloads(plat.report())
        if pkg == "torch":
            tree, _ = sb.checkpoint.restore(1, like=sb._ckpt_like)
            leaf = tree[str(dep.uid)]["chacha20"]["next_ctr"]
            assert leaf.dtype == torch.int64 and leaf.device.type == "cpu"
            assert int(leaf) == want
    assert len(got["torch"]) == 2
    for j, t in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(j, t)


def crash_with_queued(pkg, ckpt):
    plan = FAULTS[pkg].FaultPlan(seed=1).crash(shard=0, epoch=1)
    sb, plat, dep = fleet(pkg, 2, plan, health_threshold=1,
                          checkpoint=str(ckpt))
    sb.inject("a", dep.uid, state=mk_batch(0))
    sb.run()                                   # epoch 0: completes on c0
    for i in (1, 2, 3):                        # queued, then c0 dies
        sb.inject("a", dep.uid, state=mk_batch(i))
    sb.run()                                   # epoch 1: crash + replay
    return plat.report(), dep


def test_crash_with_inflight_injects_replays_journal(tmp_path):
    """Batches queued on the dead shard (injected, never run) replay
    against the failover target instead of vanishing, in both packages,
    with the same ciphertext."""
    got = {}
    for pkg in PKGS:
        rep, dep = crash_with_queued(pkg, tmp_path / pkg / "ck")
        assert rep.extra["replayed"] == 3
        assert len(rep.tenants["a"].outputs) == 4
        assert rep.extra["routes"][dep.uid] == "c1"
        got[pkg] = (payloads(rep), fleet_extra(rep))
    for j, t in zip(got["jax"][0], got["torch"][0]):
        np.testing.assert_array_equal(j, t)
    assert got["jax"][1] == got["torch"][1]


def test_inject_retry_is_bounded_when_no_survivor():
    got = {}
    for pkg in PKGS:
        plan = FAULTS[pkg].FaultPlan(seed=1).crash(shard=0, epoch=0)
        sb, plat, dep = fleet(pkg, 1, plan, health_threshold=1)
        sb.run()                               # applies the crash
        with pytest.raises(FAULTS[pkg].ShardCrashed):
            sb.inject("a", dep.uid, state=mk_batch(0))
        assert sb.lost["injects"] == 1
        assert sb.retries >= 1 and sb.backoff_ns_total > 0
        got[pkg] = (dict(sb.lost), sb.retries, sb.backoff_ns_total,
                    list(sb.failovers))
    assert got["jax"] == got["torch"]


def test_corrupt_fault_flips_payload_bits():
    """A corrupt fault flips the same payload bit in both packages (the
    FaultState's seeded rng), and the batch is still delivered."""
    got = {}
    for pkg in PKGS:
        plan = FAULTS[pkg].FaultPlan(seed=4).corrupt(shard=0, epoch=0,
                                                     prob=1.0)
        sb, plat, dep = fleet(pkg, 1, plan)
        sb.run()                               # arm the fault
        sb.inject("a", dep.uid, state=mk_batch(0))
        sb.run()
        assert sb.shards[0].faults.corrupted == 1
        rep = plat.report()
        assert len(rep.tenants["a"].outputs) == 1
        got[pkg] = payloads(rep)[0]
    np.testing.assert_array_equal(got["jax"], got["torch"])


# ============================================================ invariants ==
@pytest.mark.parametrize("pkg", PKGS)
def test_compute_fleet_batch_law_holds_with_shed_and_replay(
        monkeypatch, tmp_path, pkg):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert INV[pkg].enabled()
    plan = FAULTS[pkg].FaultPlan(seed=3).crash(shard=0, epoch=1)
    sb, plat, dep = fleet(pkg, 2, plan, health_threshold=1,
                          checkpoint=str(tmp_path / "ck"))
    for ep in range(3):
        sb.inject("a", dep.uid, state=mk_batch(ep))
        sb.run()                  # sanitized: I-BATCH audited per drain
    assert INV[pkg].failover_diags(sb, "test") == []
    assert sb.failovers and sb.lost["deployments"] == 0


def test_failover_diags_flag_route_to_dead_shard():
    sb, plat, dep = fleet("torch", 2)
    assert tinv.failover_diags(sb, "t") == []
    sb.healthy[0] = False         # corrupt: the route points at a corpse
    diags = tinv.failover_diags(sb, "t")
    assert diags and any("I-FAILOVER" in d.rule for d in diags)


def test_add_shard_and_migrate_on_compute():
    """A spare compute shard joining mid-run inherits the specs and
    tenants, takes a migration, and serves the deployment's next batch
    with the same bits as the JAX package's fleet."""
    got = {}
    for pkg in PKGS:
        api = API[pkg]
        sb, plat, dep = fleet(pkg, 2)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        spare = api.ComputeBackend(name="spare", **kw)
        i = sb.add_shard(spare)
        assert i == 2 and "a" in spare.sched.queues
        assert sb.migrate(dep.uid, i) and sb.routes[dep.uid] == i
        sb.inject("a", dep.uid, state=mk_batch(5))
        sb.run()
        rep = plat.report()
        assert rep.tenants["a"].pkts_done == 8
        got[pkg] = (payloads(rep), fleet_extra(rep))
    np.testing.assert_array_equal(got["jax"][0][0], got["torch"][0][0])
    assert got["jax"][1] == got["torch"][1]
