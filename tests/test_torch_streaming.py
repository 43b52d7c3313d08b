"""The PyTorch port's streaming datapath held against the JAX package's.

The ten scenarios of ``tests/test_streaming.py`` run on both packages with
the same numpy-drawn packets and parameters (``device="cpu"`` for the
port): batch, stream and round-robin outputs over bucket-straddling sizes,
scalar against array stream counters, the dispatch ring's allocations, the
ring-wrap exact fill, ``bucket_size``, the batch and stream throughput
windows under a counting clock, ``inject_stream`` epochs, a mid-stream
fault parking the backlog and a mid-stream shard crash replaying
bit-exact.  The arithmetic is integer, so outputs compare exactly.  The
JAX package runs its composed path (as its own tests do) or, where a case
says so, its Pallas megakernel in interpret mode; the port runs its
composed path or its plain fused version.  One more case pins the ring's
ordering rule: a slot is never handed out again while its group is in
flight.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import repro.api as japi
import repro.faults as jfaults
from repro.serving import vpc as jvpc

import repro_torch.api as tapi
import repro_torch.faults as tfaults
from repro_torch.convert import params_from_numpy

API = {"jax": japi, "torch": tapi}
FAULTS = {"jax": jfaults, "torch": tfaults}

RULES = tuple(np.array(x) for x in jvpc.make_rules(32, seed=2))
KEY = np.arange(8, dtype=np.uint32) * 3 + 1
NONCE = np.arange(3, dtype=np.uint32) + 7
VPC_PARAMS = {"firewall": {"rules": RULES}, "nat": {"nat_ip": 0x0A000001},
              "chacha20": {"key": KEY, "nonce": NONCE}}
FW_PARAMS = {"firewall": {"rules": RULES}}
VPC = ("firewall", "nat", "chacha20")
FW_NAT = ("firewall", "nat")
FIELDS = ("allow", "headers", "payload")


def to_pkg(pkg, params):
    """numpy params -> the package's arrays (tensors on the CPU)."""
    if pkg == "torch":
        return params_from_numpy(params, "cpu")
    out = {k: dict(v) for k, v in params.items()}
    for v in out.values():
        if "rules" in v:
            v["rules"] = tuple(jnp.asarray(x) for x in v["rules"])
        for k in ("key", "nonce"):
            if k in v:
                v[k] = jnp.asarray(v[k])
    return out


def chain(pkg, names):
    api = API[pkg]
    expr = api.nt(names[0])
    for n in names[1:]:
        expr = expr >> api.nt(n)
    return expr


def mk_platform(pkg, names=VPC, params=VPC_PARAMS, port_fused=False,
                **kw):
    """One tenant ``t`` with one deployment.  The JAX package composes (as
    its own streaming tests do) unless ``use_fused`` is passed; the port
    takes its path from ``port_fused``."""
    api = API[pkg]
    kw.setdefault("use_fused", False)
    if pkg == "torch":
        kw["use_fused"] = port_fused
        kw["device"] = kw.get("device", "cpu")
    plat = api.Platform(api.ComputeBackend(**kw), specs=api.VPC_SPECS)
    dep = plat.tenant("t").deploy(chain(pkg, names),
                                  params=to_pkg(pkg, params))
    return plat, dep


def wire(pkg, a):
    return jnp.asarray(a) if pkg == "jax" else torch.from_numpy(a)


def packets(pkg, n, seed):
    h, p = (np.array(x) for x in jvpc.make_packets(n, seed=seed))
    return wire(pkg, h), wire(pkg, p)


def outputs(plat, tenant="t", fields=FIELDS) -> list[dict]:
    return [{k: np.asarray(o[k]) for k in fields}
            for o in plat.report()[tenant].outputs]


def assert_same_outputs(ref, got):
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert set(r) == set(g)
        for k in r:
            np.testing.assert_array_equal(r[k], g[k],
                                          err_msg=f"output {i} field {k!r}")


def both(scenario):
    """``scenario(pkg)`` on both packages; returns (jax, torch) results."""
    return scenario("jax"), scenario("torch")


# ====================================================== bit-exactness ====
SIZES = (1, 7, 8, 9)


@pytest.mark.parametrize("port_fused", [False, True])
def test_stream_and_round_robin_match_batch(port_fused):
    """Batch drain, streaming ring and streaming with 2-way device
    round-robin give the same ciphertext (and every other field) in each
    package, and the two packages give the same bits; on the fused path
    the JAX package runs its Pallas megakernel in interpret mode."""
    def scenario(pkg):
        res = {}
        dev2 = ([jax.devices()[0]] * 2 if pkg == "jax" else ["cpu", "cpu"])
        for mode, kw in (("batch", {}),
                         ("stream", dict(stream=True, ring_depth=3,
                                         max_inflight=2)),
                         ("rr", dict(stream=True, device=dev2))):
            plat, dep = mk_platform(pkg, port_fused=port_fused,
                                    use_fused=port_fused, **kw)
            for i, n in enumerate(SIZES):
                h, p = packets(pkg, n, seed=i)
                dep.inject(headers=h, payload=p)
            plat.run()
            be = plat.backend
            res[mode] = (outputs(plat), be.stats["stream_batches"],
                         be.inflight_batches, be._rr)
        return res

    jres, tres = both(scenario)
    for res in (jres, tres):
        assert_same_outputs(res["batch"][0], res["stream"][0])
        assert_same_outputs(res["batch"][0], res["rr"][0])
        assert res["stream"][1:3] == (len(SIZES), 0)
        assert res["rr"][3] >= 1
    assert_same_outputs(jres["batch"][0], tres["batch"][0])
    for mode in ("stream", "rr"):
        assert jres[mode][1:3] == tres[mode][1:3]
    assert jres["rr"][3] == tres["rr"][3]   # the JAX default has no cursor


@pytest.mark.parametrize("port_fused", [False, True])
def test_scalar_slot_ctr_matches_array_ctr(port_fused):
    """The ring's per-slot scalar counter base (``scalar_ctr``: one u32 a
    slot, expanded on the device) gives the same ciphertext as the
    per-packet counter array across a continuing stream, in both
    packages."""
    sizes = (1, 7, 8, 5)
    ch = VPC_PARAMS["chacha20"]
    scalar = {**VPC_PARAMS, "chacha20": {**ch, "stream": True,
                                         "scalar_ctr": True}}
    array = {**VPC_PARAMS, "chacha20": {**ch, "stream": True}}

    def scenario(pkg):
        plat_s, dep_s = mk_platform(pkg, params=scalar, stream=True,
                                    ring_depth=2, max_inflight=1,
                                    port_fused=port_fused)
        plat_a, dep_a = mk_platform(pkg, params=array, port_fused=port_fused)
        for i, n in enumerate(sizes):
            h, p = packets(pkg, n, seed=10 + i)
            dep_s.inject(headers=h, payload=p)
            dep_a.inject(headers=h, payload=p)
        plat_s.run()
        plat_a.run()
        return (outputs(plat_s), outputs(plat_a),
                plat_s.backend.export_state(dep_s.uid),
                plat_s.backend.ring.stats())

    jres, tres = both(scenario)
    for s_out, a_out, state, _ in (jres, tres):
        assert_same_outputs(a_out, s_out)
        assert state == {"chacha20": {"next_ctr": 1 + sum(sizes)}}
    assert_same_outputs(jres[0], tres[0])
    assert jres[3] == tres[3]


# ========================================================== the ring ====
def test_zero_steady_state_allocations():
    """After warm-up every ring acquire is a reuse, in both packages, with
    the same counts."""
    def scenario(pkg):
        plat, dep = mk_platform(pkg, names=FW_NAT, params=FW_PARAMS,
                                stream=True, ring_depth=2, max_inflight=1)
        be = plat.backend
        h, p = packets(pkg, 8, seed=0)
        src = (("t", dep.uid, {"headers": h, "payload": p})
               for _ in range(12))
        served = be.inject_stream(src, epoch_batches=1)
        return served, be.ring.stats(), be.completed_batches, \
            be.max_inflight, outputs(plat)

    jres, tres = both(scenario)
    served, ring, completed, max_inflight, _ = tres
    assert served == completed == 12
    assert ring["allocs"] <= max_inflight + 1
    assert ring["reuses"] >= 12 - ring["allocs"]
    assert jres[:4] == tres[:4]
    assert_same_outputs(jres[4], tres[4])


def test_ring_wrap_exact_fill():
    """A backlog of exactly ring_depth x bucket rows in exact-bucket
    batches stays in its bucket at the ring wrap: one program, nothing
    lost, same bits in both packages."""
    depth, bucket = 2, 8

    def scenario(pkg):
        plat, dep = mk_platform(pkg, names=FW_NAT, params=FW_PARAMS,
                                stream=True, ring_depth=depth,
                                max_inflight=depth)
        be = plat.backend
        src = (("t", dep.uid, dict(zip(("headers", "payload"),
                                       packets(pkg, bucket, seed=20 + i))))
               for i in range(depth))
        served = be.inject_stream(src, epoch_batches=1)
        outs = outputs(plat)
        return (served, [o["headers"].shape[0] for o in outs],
                be.stats["traces"], be.inflight_batches,
                be.completed_batches, outs)

    jres, tres = both(scenario)
    assert tres[:5] == (depth, [bucket] * depth, 1, 0, depth)
    assert jres[:5] == tres[:5]
    assert_same_outputs(jres[5], tres[5])


def test_bucket_size_exact_fits_and_edges():
    from repro.api.compute_backend import bucket_size as jbucket
    assert [tapi.bucket_size(n) for n in (0, 1, 8, 9, 16, 17)] == \
        [8, 8, 8, 16, 16, 32]
    assert [tapi.bucket_size(n) for n in range(0, 1100)] == \
        [jbucket(n) for n in range(0, 1100)]
    for f in (tapi.bucket_size, jbucket):
        with pytest.raises(ValueError):
            f(-1)


# ==================================================== throughput window ====
def counting_clock(monkeypatch):
    """``time.perf_counter`` returns 1, 2, 3, ... (the module attribute is
    shared, so both packages read it)."""
    import repro_torch.api.compute_backend as cb
    calls = {"n": 0}

    def fake():
        calls["n"] += 1
        return float(calls["n"])

    monkeypatch.setattr(cb.time, "perf_counter", fake)
    return calls


def test_batch_window_is_two_reads(monkeypatch):
    """Batch-mode run() reads the clock exactly twice (start, post-sync),
    so its report() numbers are unchanged by the streaming engine."""
    calls = counting_clock(monkeypatch)

    def scenario(pkg):
        plat, dep = mk_platform(pkg, names=FW_NAT, params=FW_PARAMS)
        h, p = packets(pkg, 8, seed=0)
        for _ in range(3):
            dep.inject(headers=h, payload=p)
        before = calls["n"]
        plat.run()
        return (plat.backend._elapsed_s, calls["n"] - before,
                plat.report().duration_ns)

    jres, tres = both(scenario)
    assert tres == (1.0, 2, pytest.approx(1.0e9))
    assert jres == tres


def test_stream_window_first_dispatch_to_last_drain(monkeypatch):
    """The streaming window opens at the first ring launch and closes at
    the last drain: one clock read at the first stage and one per
    retire."""
    counting_clock(monkeypatch)

    def scenario(pkg):
        api = API[pkg]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        be = api.ComputeBackend(use_fused=False, stream=True, **kw)
        plat = api.Platform(be, specs=api.VPC_SPECS)
        ten = plat.tenant("t")
        p = to_pkg(pkg, FW_PARAMS)
        dep1 = ten.deploy(chain(pkg, FW_NAT), params=p)
        dep2 = ten.deploy(chain(pkg, ("nat", "firewall")), params=p)
        h, pl = packets(pkg, 8, seed=0)
        for dep in (dep1, dep2, dep1):   # 3 non-coalescable groups
            dep.inject(headers=h, payload=pl)
        plat.run()
        return be._elapsed_s, plat.report().duration_ns

    jres, tres = both(scenario)
    assert tres == (3.0, pytest.approx(3.0e9))
    assert jres == tres


# ======================================================= inject_stream ====
@pytest.mark.parametrize("epoch_batches,epoch_cost", [
    (2, None), (1, None), (5, None), (2, 8 * 84.0), (4, 3 * 8 * 84.0)])
def test_epoch_serviced_generator(monkeypatch, epoch_batches, epoch_cost):
    """``inject_stream`` services a generator epoch by epoch (under the
    sanitizer's I-BATCH audit), with or without a credit window, and the
    two packages serve the same batches in the same epochs."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")

    def scenario(pkg):
        plat, dep = mk_platform(pkg, names=FW_NAT, params=FW_PARAMS,
                                stream=True, ring_depth=4)
        be = plat.backend
        src = (("t", dep.uid, dict(zip(("headers", "payload"),
                                       packets(pkg, 8, seed=i))))
               for i in range(5))
        served = be.inject_stream(src, epoch_batches=epoch_batches,
                                  epoch_cost=epoch_cost)
        return (served, be.stats["stream_epochs"], be.inflight_batches,
                be.stats["dispatches"], outputs(plat))

    jres, tres = both(scenario)
    assert tres[0] == 5 and tres[2] == 0 and len(tres[4]) == 5
    assert tres[1] >= -(-5 // epoch_batches)
    assert jres[:4] == tres[:4]
    assert_same_outputs(jres[4], tres[4])


def test_midstream_fault_parks_backlog():
    """A crashed shard interrupts the stream instead of raising: queued
    work stays on the fair queues, the interrupt is counted, and a
    recovered shard drains it."""
    def scenario(pkg):
        plat, dep = mk_platform(pkg, names=FW_NAT, params=FW_PARAMS,
                                stream=True)
        be = plat.backend
        be.faults = FAULTS[pkg].FaultState(be.name)
        h, p = packets(pkg, 8, seed=0)
        for _ in range(2):
            dep.inject(headers=h, payload=p)
        be.faults.crashed = True
        served = be.inject_stream(iter(()))
        parked = (served, be.faults.stream_interrupts, be.sched.pending(),
                  be.completed_batches)
        be.faults.crashed = False
        plat.run()
        return parked, be.completed_batches, outputs(plat)

    jres, tres = both(scenario)
    assert tres[:2] == ((0, 1, 2, 0), 2)
    assert jres[:2] == tres[:2]
    assert_same_outputs(jres[2], tres[2])


# ============================================== fleet: crash mid-stream ====
def run_stream_fleet(pkg, crash, ckpt=None, scalar_ctr=False):
    """``tests/test_streaming.py``'s fleet: two streaming shards, the
    stream-ctr ``firewall >> chacha20`` chain pinned to shard 0, crash at
    epoch 2, failover and journal replay."""
    api, faults = API[pkg], FAULTS[pkg]
    plan = faults.FaultPlan(seed=3).crash(shard=0, epoch=2) if crash \
        else None
    kw = {"device": "cpu"} if pkg == "torch" else {}
    shards = [api.ComputeBackend(name=f"c{i}", stream=True, ring_depth=2,
                                 **kw) for i in range(2)]
    sb = api.ShardedBackend(shards, auto_rebalance=False, fault_plan=plan,
                            health_threshold=1,
                            checkpoint=str(ckpt) if ckpt else None)
    plat = api.Platform(sb, specs=api.VPC_SPECS)
    ten = plat.tenant("a", weight=1.0)
    params = to_pkg(pkg, {"firewall": {"rules": RULES},
                          "chacha20": {"stream": True, "key": KEY,
                                       "nonce": NONCE, "counter0": 1,
                                       "scalar_ctr": scalar_ctr}})
    dep = ten.deploy(chain(pkg, ("firewall", "chacha20")), shard=0,
                     params=params)
    rng = np.random.default_rng(7)
    for _ in range(4):
        sb.inject("a", dep.uid, state={
            "headers": rng.integers(0, 2 ** 31, (8, 5), dtype=np.uint32),
            "payload": rng.integers(0, 2 ** 31, (8, 16), dtype=np.uint32)})
        sb.run()
    rep = plat.report()
    outs = [np.asarray(o["payload"]) for o in rep.tenants["a"].outputs]
    return np.concatenate(outs), rep


@pytest.mark.parametrize("scalar_ctr", [False, True])
def test_midstream_crash_replays_bit_exact(tmp_path, scalar_ctr):
    """Crash, failover from the checkpoint and journal replay leave the
    output stream bit-identical to the crash-free run, and equal to the
    JAX package's, with the same failover report."""
    got = {}
    for pkg in API:
        ref, _ = run_stream_fleet(pkg, crash=False, scalar_ctr=scalar_ctr)
        out, rep = run_stream_fleet(pkg, crash=True,
                                    ckpt=tmp_path / pkg / "ckpt",
                                    scalar_ctr=scalar_ctr)
        (fo,) = rep.extra["failovers"]
        assert fo["shard"] == "c0" and fo["lost"] == []
        assert rep.extra["replayed"] >= 1
        assert rep.extra["lost"]["deployments"] == 0
        np.testing.assert_array_equal(ref, out)
        got[pkg] = (out, rep.extra["failovers"], rep.extra["replayed"],
                    rep.extra["lost"], rep.extra["routes"])
    np.testing.assert_array_equal(got["jax"][0], got["torch"][0])
    assert got["jax"][1:] == got["torch"][1:]


# ====================================================== ring ordering ====
@pytest.mark.parametrize("max_inflight,ring_depth", [(1, 1), (2, 4)])
def test_slot_never_reacquired_while_in_flight(monkeypatch, max_inflight,
                                               ring_depth):
    """A slot goes back to the free list only when its group retires (on
    the card: after the event that follows its copy and its program), so
    no acquire may return a slot whose group is still in flight; at most
    ``max_inflight + 1`` slots of one key are ever live.  Mixed sizes
    exercise several buckets; outputs and ring counts equal the JAX
    package's."""
    from repro_torch.api.compute_backend import DispatchRing
    live: dict[int, tuple] = {}
    peak = {"n": 0}
    acquire, release = DispatchRing.acquire, DispatchRing.release

    def watched_acquire(self, *a, **kw):
        slot = acquire(self, *a, **kw)
        assert id(slot) not in live, "slot handed out while in flight"
        live[id(slot)] = slot.key
        same = sum(1 for k in live.values() if k == slot.key)
        peak["n"] = max(peak["n"], same)
        return slot

    def watched_release(self, slot):
        del live[id(slot)]
        release(self, slot)

    monkeypatch.setattr(DispatchRing, "acquire", watched_acquire)
    monkeypatch.setattr(DispatchRing, "release", watched_release)
    sizes = (8, 3, 8, 16, 9, 8, 1, 16, 8, 8, 5, 12)

    def scenario(pkg):
        plat, dep = mk_platform(pkg, stream=True, ring_depth=ring_depth,
                                max_inflight=max_inflight)
        be = plat.backend
        src = (("t", dep.uid, dict(zip(("headers", "payload"),
                                       packets(pkg, n, seed=40 + i))))
               for i, n in enumerate(sizes))
        served = be.inject_stream(src, epoch_batches=1)
        return served, be.ring.stats(), outputs(plat)

    jres, tres = both(scenario)
    assert not live and peak["n"] <= max_inflight + 1
    assert tres[0] == len(sizes)
    assert jres[:2] == tres[:2]
    assert_same_outputs(jres[2], tres[2])
