"""Fleets with sim shards, on the port and on the JAX package: equal reports.

``ShardedBackend``'s event-driven paths (sources routed back through the
fleet, the cross-shard epoch over sim shards, failover of sim shards,
churn) had nothing to drive in the port until the sim substrate came.  The
scenarios of ``tests/test_sched.py::TestShardedSimFairness``,
``tests/test_faults.py::TestSimFailover`` / ``TestRackMigrateBack`` /
``TestFaultInvariants`` (sim cases), and ``tests/test_workloads.py::
TestDriver`` / ``TestTraceInvariant`` run here on both packages, with the
reference's assertions inside each scenario and the observations compared
exactly (helpers in ``test_torch_sim.py``).  A mixed fleet's compute shard
is the port's ``ComputeBackend`` on the CPU.

Also held equal: the kill-1-of-4 resilience scenario at its smoke size,
the port-side copy in ``chip_smoke.py`` against
``benchmarks.bench_resilience._run_once``, and the paper's figures 16 and
17 of ``benchmarks/figures.py`` replayed through the port's SimBackend and
SNIC.
"""
from __future__ import annotations

import json
import sys
import types

import pytest

from test_torch_sim import PORT, REF, ROOT, chain, nic_state, plain, same

FW_NAT = ("firewall", "nat")


def fleet_obs(plat) -> list:
    """A fleet platform's report, its solver's last grants and epochs, and
    every sim shard's per-sNIC state."""
    sb = plat.backend
    return [plat.report(), sb.last_grants, sb.global_epochs,
            [[nic_state(n) for n in s.snics] for s in sb.shards
             if hasattr(s, "snics")]]


def compute_obs(rep) -> dict:
    """What a compute backend's report holds that is not a wall-clock
    reading (its window, latencies and Gbit/s are timed on the host):
    per tenant the packets and bytes done and the outputs."""
    return {t: [tr.pkts_done, tr.bytes_done, tr.drops, tr.outputs]
            for t, tr in rep.tenants.items()}


# =================================== test_sched.py::TestShardedSimFairness ==
def global_weighted_shares_converge(m, w):
    plat = m.api.Platform([m.api.SimBackend(name="s0"),
                           m.api.SimBackend(name="s1")],
                          specs=m.api.VPC_SPECS)
    heavy = plat.tenant("heavy", weight=w)
    light = plat.tenant("light", weight=1.0)
    deps = [t.deploy(chain(m, FW_NAT), shard=s)
            for s in (0, 1) for t in (heavy, light)]
    plat.backend.settle()
    for i, d in enumerate(deps):
        d.source("poisson", rate_gbps=250.0, mean_bytes=1000, seed=i + 1,
                 duration_ms=2.0)
    plat.run(duration_ms=2.0)
    rep = plat.report()
    ratio = rep["heavy"].bytes_done / rep["light"].bytes_done
    assert ratio == pytest.approx(w, rel=0.05), ratio
    for t in ("heavy", "light"):
        ps = rep[t].extra["per_shard"]
        assert set(ps) == {"s0", "s1"}
        assert sum(v["bytes_done"] for v in ps.values()) == rep[t].bytes_done
    assert rep.extra["global_epochs"] > 10
    assert rep["heavy"].extra["weight"] == w
    return fleet_obs(plat)


def mixed_fleet_compute_backlog_cannot_throttle_sim_share(m):
    """A sim shard beside a compute shard (the port's on the CPU): the
    global epoch is scoped to the shards that just ran, so a standing
    compute backlog does not shrink tenant a's sim-side grant."""
    plat = m.api.Platform([m.api.SimBackend(name="edge"),
                           m.compute(use_fused=False, name="gpu0")],
                          specs=m.api.VPC_SPECS)
    a = plat.tenant("a", weight=2.0)
    b = plat.tenant("b", weight=1.0)
    d_a = a.deploy(chain(m, FW_NAT), shard=0)
    d_b = b.deploy(chain(m, FW_NAT), shard=0)
    d_cmp = a.deploy(chain(m), params=m.vpc_params(), shard=1)
    plat.backend.settle()
    d_a.source("poisson", rate_gbps=300.0, mean_bytes=1000, seed=1,
               duration_ms=2.0)
    d_b.source("poisson", rate_gbps=300.0, mean_bytes=1000, seed=2,
               duration_ms=2.0)
    h, p = m.packets(64, seed=3)
    for _ in range(8):
        d_cmp.inject(headers=h, payload=p)
    plat.run(duration_ms=2.0)
    rep = plat.report()
    ps = {t: rep[t].extra["per_shard"] for t in ("a", "b")}
    ratio = ps["a"]["edge"]["bytes_done"] / ps["b"]["edge"]["bytes_done"]
    assert ratio == pytest.approx(2.0, rel=0.1), ratio
    assert ps["a"]["gpu0"]["pkts_done"] == 8 * 64
    sb = plat.backend
    return [rep.shards["edge"], compute_obs(rep.shards["gpu0"]),
            sb.last_grants, sb.global_epochs,
            [nic_state(n) for n in sb.shards[0].snics]]


def attached_source_follows_migration(m):
    sb = m.api.ShardedBackend([m.api.SimBackend(name="s0"),
                               m.api.SimBackend(name="s1")],
                              auto_rebalance=False)
    plat = m.api.Platform(sb, specs=m.api.VPC_SPECS)
    dep = plat.tenant("a").deploy(chain(m, FW_NAT), shard=0)
    sb.settle()
    dep.source("poisson", rate_gbps=20.0, mean_bytes=1000, seed=1,
               duration_ms=8.0)
    plat.run(duration_ms=0.8)
    assert sb.migrate(dep.uid, 1)
    plat.run(duration_ms=6.5)
    ps = plat.report()["a"].extra["per_shard"]
    assert 0 < ps["s0"]["pkts_done"] < ps["s1"]["pkts_done"]
    return fleet_obs(plat) + [sb.routes]


def spanning_aggressor_yields_contended_shard(m):
    plat = m.api.Platform([m.api.SimBackend(name="s0"),
                           m.api.SimBackend(name="s1")],
                          specs=m.api.VPC_SPECS)
    heavy = plat.tenant("heavy", weight=2.0)
    light = plat.tenant("light", weight=1.0)
    deps = (heavy.deploy(chain(m, FW_NAT), shard=0),
            heavy.deploy(chain(m, FW_NAT), shard=1),
            light.deploy(chain(m, FW_NAT), shard=0))
    plat.backend.settle()
    for i, d in enumerate(deps):
        d.source("poisson", rate_gbps=250.0, mean_bytes=1000, seed=i + 1,
                 duration_ms=2.0)
    plat.run(duration_ms=2.0)
    rep = plat.report()
    s0 = {t: rep[t].extra["per_shard"]["s0"]["bytes_done"]
          for t in ("heavy", "light")}
    assert s0["heavy"] / s0["light"] < 1.0
    grants = plat.backend.last_grants
    assert grants[0]["heavy"] / grants[0]["light"] == \
        pytest.approx(0.5, rel=0.02)
    ratio = rep["heavy"].bytes_done / rep["light"].bytes_done
    assert ratio == pytest.approx(2.0, rel=0.15), ratio
    return fleet_obs(plat)


@pytest.mark.parametrize("w", [2.0, 3.0])
def test_global_weighted_shares_converge_like_jax(w):
    same(global_weighted_shares_converge, w)


@pytest.mark.parametrize("scenario", [
    mixed_fleet_compute_backlog_cannot_throttle_sim_share,
    attached_source_follows_migration,
    spanning_aggressor_yields_contended_shard], ids=lambda f: f.__name__)
def test_sharded_sim_fairness_like_jax(scenario):
    same(scenario)


def test_mixed_fleet_compute_outputs_equal_jax_bits():
    """The mixed fleet's compute shard serves the same bits in both
    packages (the fleet observation above compares counts and floats)."""
    outs = {}
    for m in (REF, PORT):
        plat = m.api.Platform([m.api.SimBackend(name="edge"),
                               m.compute(use_fused=False, name="gpu0")],
                              specs=m.api.VPC_SPECS)
        dep = plat.tenant("a", weight=2.0).deploy(
            chain(m), params=m.vpc_params(), shard=1)
        plat.tenant("b").deploy(chain(m, FW_NAT), shard=0)
        plat.backend.settle()
        for s in range(3):
            h, p = m.packets(16, seed=s)
            dep.inject(headers=h, payload=p)
        plat.run(duration_ms=0.2)
        outs[m.name] = plain(plat.report()["a"].outputs)
    assert len(outs["repro"]) == 3 and outs["repro"] == outs["repro_torch"]


# ====================================== test_faults.py::TestSimFailover ==
def sim_fleet(m, n=4, plan=None, **kw):
    shards = [m.api.SimBackend(name=f"s{i}", seed=i) for i in range(n)]
    kw.setdefault("auto_rebalance", False)
    sb = m.api.ShardedBackend(shards, fault_plan=plan, **kw)
    return sb, m.api.Platform(sb, specs=m.api.VPC_SPECS)


def deploy_tenants(m, plat, tenants=("a", "b", "c", "d"),
                   weights=(2, 2, 1, 1)):
    return [plat.tenant(t, weight=float(w)).deploy(
                chain(m, FW_NAT), shard=i % len(plat.backend.shards))
            for i, (t, w) in enumerate(zip(tenants, weights))]


def run_faulted(m, plan, dur_ms=3.0, **kw):
    sb, plat = sim_fleet(m, plan=plan, health_threshold=2, **kw)
    deps = deploy_tenants(m, plat)
    sb.settle()
    for d in deps:
        d.source("poisson", rate_gbps=2.0, mean_bytes=1000,
                 duration_ms=dur_ms)
    plat.run(duration_ms=dur_ms)
    return sb, plat, deps, plat.report()


def failover_obs(sb, plat) -> list:
    return fleet_obs(plat) + [sb.routes, sb.healthy, sb.capacity_gbps,
                              sb.tenant_weights]


def crash_during_epoch_fails_over(m):
    sb, plat, deps, rep = run_faulted(
        m, m.faults.FaultPlan(seed=7).crash(shard=2, epoch=6))
    assert rep.extra["health"] == {"s0": True, "s1": True, "s2": False,
                                   "s3": True}
    (fo,) = rep.extra["failovers"]
    assert fo["shard"] == "s2" and fo["lost"] == []
    assert rep.extra["lost"]["deployments"] == 0
    assert rep.extra["routes"][deps[2].uid] != "s2"
    assert rep.tenants["c"].pkts_done > 0
    return failover_obs(sb, plat)


def hang_then_recover_rejoins(m):
    sb, plat, deps, rep = run_faulted(
        m, m.faults.FaultPlan(seed=7).hang(shard=1, epoch=4, duration=8),
        dur_ms=4.0)
    assert rep.extra["health"]["s1"]
    assert any(name == "s1" for _, name in rep.extra["recoveries"])
    assert rep.extra["failovers"][0]["shard"] == "s1"
    return failover_obs(sb, plat)


def same_seed_reproduces_identical_report(m):
    def fingerprint():
        plan = (m.faults.FaultPlan(seed=11).crash(shard=2, epoch=5)
                .degrade(shard=0, epoch=3, factor=0.5, duration=4)
                .drop(shard=1, epoch=2, prob=0.05, duration=6))
        _, _, _, rep = run_faulted(m, plan)
        return json.dumps({
            "failovers": rep.extra["failovers"], "lost": rep.extra["lost"],
            "pkts": {t: r.pkts_done for t, r in rep.tenants.items()},
            "drops": {t: r.drops for t, r in rep.tenants.items()},
        }, sort_keys=True)
    first = fingerprint()
    assert first == fingerprint()
    return first


def double_failure_sheds_cleanly(m):
    plan = m.faults.FaultPlan(seed=5).crash(shard=0, epoch=4).crash(
        shard=1, epoch=4)
    sb, plat = sim_fleet(m, n=3, plan=plan, health_threshold=1, shed_after=1,
                         shed_headroom=1.2, shed_window_epochs=1.0)
    deps = deploy_tenants(m, plat, tenants=("a", "b", "c"),
                          weights=(1, 1, 1))
    sb.settle()
    plat.run(duration_ms=1.0)
    assert sb.healthy == [False, False, True]
    for _ in range(250):
        for t, d in zip("abc", deps):
            sb.inject(t, d.uid, 9000)
    plat.run(duration_ms=1.0)
    rep = plat.report()
    assert rep.extra["health"] == {"s0": False, "s1": False, "s2": True}
    assert rep.extra["lost"]["deployments"] == 0
    assert rep.extra["shed"]["items"] > 0
    assert sum(r.drops for r in rep.tenants.values()) >= \
        rep.extra["shed"]["items"]
    return failover_obs(sb, plat)


def all_shards_dead_counts_lost_deployments(m):
    plan = m.faults.FaultPlan(seed=5).crash(shard=0, epoch=2).crash(
        shard=1, epoch=2)
    sb, plat = sim_fleet(m, n=2, plan=plan, health_threshold=1)
    deps = deploy_tenants(m, plat, tenants=("a", "b"), weights=(1, 1))
    sb.settle()
    for d in deps:
        d.source("poisson", rate_gbps=2.0, mean_bytes=1000, duration_ms=2.0)
    plat.run(duration_ms=2.0)
    rep = plat.report()
    assert rep.extra["lost"]["deployments"] == 2
    assert not any(rep.extra["health"].values())
    return failover_obs(sb, plat)


def tenant_churn_mid_run(m):
    plan = (m.faults.FaultPlan(seed=2).remove_tenant("b", epoch=5)
            .add_tenant("e", epoch=3, weight=2.0))
    sb, plat, deps, rep = run_faulted(m, plan)
    assert "b" not in sb.tenant_weights
    assert sb.tenant_weights.get("e") == 2.0
    assert rep.tenants["b"].pkts_done > 0
    churn = rep.extra["faults"]["churn"]
    assert (5, "remove_tenant", "b") in churn
    assert (3, "add_tenant", "e") in churn
    return failover_obs(sb, plat)


def degrade_shrinks_placer_capacity(m):
    sb, plat, deps, rep = run_faulted(
        m, m.faults.FaultPlan(seed=2).degrade(shard=0, epoch=2, factor=0.25))
    assert sb.capacity_gbps[0] == pytest.approx(0.25 * sb._nominal_gbps[0])
    assert sb.placer.capacities[0] == pytest.approx(sb.capacity_gbps[0])
    assert rep.extra["health"]["s0"]
    return failover_obs(sb, plat) + [sb.placer.capacities]


@pytest.mark.parametrize("scenario", [
    crash_during_epoch_fails_over, hang_then_recover_rejoins,
    same_seed_reproduces_identical_report, double_failure_sheds_cleanly,
    all_shards_dead_counts_lost_deployments, tenant_churn_mid_run,
    degrade_shrinks_placer_capacity], ids=lambda f: f.__name__)
def test_sim_failover_like_jax(scenario):
    same(scenario)


def migrate_back_gives_up_after_bounded_retries(m):
    specs = {"NT1": m.core.NTSpec("NT1", max_gbps=100.0, fixed_ns=100.0)}
    sim = m.core.EventSim()
    rack = m.core.make_rack(sim, 2, specs, cfg_kw=dict(
        n_regions=1, region_slots=4, enable_drf=False,
        enable_autoscale=False))
    a, b = rack.snics
    prog = m.core.ChainProgram(("NT1",))
    Rack = m.distributed.Rack
    rack._retry_migrate_back(a, b, 1, prog,
                             attempt=Rack.MIGRATE_BACK_ATTEMPTS)
    assert rack.migrate_back_giveups == 1
    before = len(sim._heap)
    rack._retry_migrate_back(a, b, 1, prog, attempt=3)
    assert len(sim._heap) == before + 1
    assert rack.migrate_back_giveups == 1
    return [Rack.MIGRATE_BACK_ATTEMPTS, [(t, s) for t, s, *_ in sim._heap],
            sim.now]


def test_rack_migrate_back_like_jax():
    """``TestRackMigrateBack``: the bounded retry ladder, with the retry
    event's time and sequence number equal."""
    same(migrate_back_gives_up_after_bounded_retries)


# ================================ sanitized: conservation under faults ==
def conservation_under_faults(m):
    plan = (m.faults.FaultPlan(seed=13).crash(shard=2, epoch=5)
            .degrade(shard=0, epoch=3, factor=0.5, duration=4)
            .drop(shard=1, epoch=2, prob=0.05, duration=6)
            .remove_tenant("d", epoch=8))
    sb, plat = sim_fleet(m, plan=plan, health_threshold=2, shed_after=1)
    deps = deploy_tenants(m, plat)
    sb.settle()
    for d in deps:
        d.source("poisson", rate_gbps=2.0, mean_bytes=1000, duration_ms=3.0)
    plat.run(duration_ms=3.0)
    rep = plat.report()
    assert rep.extra["failovers"]
    return failover_obs(sb, plat)


@pytest.mark.invariants
def test_sim_fleet_conservation_under_faults_like_jax(monkeypatch):
    """``test_sim_fleet_conservation_holds_under_faults`` with
    ``REPRO_SANITIZE=1``: crash, degrade, drop and ``remove_tenant`` on sim
    shards, every conservation law audited at each global epoch in both
    packages, and the runs equal."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    same(conservation_under_faults)


@pytest.mark.invariants
def test_failover_diags_flag_route_to_dead_shard_like_jax():
    diags = {}
    for m in (REF, PORT):
        sb, plat = sim_fleet(m, n=2)
        deploy_tenants(m, plat, tenants=("a",), weights=(1,))
        assert m.inv.failover_diags(sb, "t") == []
        sb.healthy[0] = False
        diags[m.name] = [(d.rule, d.message)
                         for d in m.inv.failover_diags(sb, "t")]
        assert any("I-FAILOVER" in r for r, _ in diags[m.name])
    assert diags["repro"] == diags["repro_torch"]


# ================================= test_workloads.py::TestDriver (sim) ==
def small_trace(m, **over):
    w = m.workloads
    kw = dict(seed=7, epochs=8, n_tenants=5,
              arrival=w.diurnal(mean=4.0, period=8), churn_frac=0.4)
    return w.generate("small", **{**kw, **over})


def drive_obs(res) -> list:
    return [res.backend, res.trace_fingerprint, res.schedule_fingerprint,
            res.census, res.injected, res.served, res.counters(), res.report]


def sim_replay_serves_everything(m):
    tr = small_trace(m)
    res = m.api.Platform(m.api.SimBackend(seed=3),
                         specs=m.api.VPC_SPECS).drive(tr)
    assert res.backend == "sim"
    assert res.trace_fingerprint == tr.fingerprint()
    assert sum(res.served.values()) == sum(res.injected.values()) \
        == tr.total_pkts
    return drive_obs(res)


def double_replay_identical(m):
    tr = small_trace(m)
    r1 = m.api.Platform(m.api.SimBackend(seed=3),
                        specs=m.api.VPC_SPECS).drive(tr)
    r2 = m.api.Platform(m.api.SimBackend(seed=3),
                        specs=m.api.VPC_SPECS).drive(tr)
    assert r1.schedule_fingerprint == r2.schedule_fingerprint
    assert r1.census == r2.census and r1.counters() == r2.counters()
    m.inv.check_trace(r1, r2, "test/small")        # I-TRACE: must not raise
    return drive_obs(r1) + drive_obs(r2)


def sim_vs_compute_schedule_and_census_identical(m):
    tr = small_trace(m, epochs=4, n_tenants=3,
                     arrival=m.workloads.constant(2.0), churn_frac=0.0)
    r_sim = m.api.Platform(m.api.SimBackend(seed=3),
                           specs=m.api.VPC_SPECS).drive(tr)
    r_cmp = m.api.Platform(m.compute(), specs=m.api.VPC_SPECS).drive(tr)
    assert r_sim.schedule_fingerprint == r_cmp.schedule_fingerprint
    assert r_sim.census == r_cmp.census
    assert r_sim.injected == r_cmp.injected
    return drive_obs(r_sim) + [r_cmp.backend, r_cmp.schedule_fingerprint,
                               r_cmp.census, r_cmp.injected, r_cmp.served,
                               compute_obs(r_cmp.report)]


def churn_removes_tenant_from_backend(m):
    w = m.workloads
    tr = w.Trace("churn", seed=1, epochs=4, tenants=[
        w.TraceTenant("stay", pkt_bytes=500),
        w.TraceTenant("brief", pkt_bytes=500, join_epoch=1, leave_epoch=3)],
        events=[(0, "stay", 2), (1, "brief", 2), (3, "stay", 1)])
    plat = m.api.Platform(m.api.SimBackend(seed=3), specs=m.api.VPC_SPECS)
    res = plat.drive(tr)
    assert "brief" not in plat.tenants and "stay" in plat.tenants
    assert res.census[1] == ["brief", "stay"] and res.census[3] == ["stay"]
    return drive_obs(res) + [sorted(plat.tenants)]


def sharded_sim_replay(m):
    """The driver's ``"sharded"`` kind: a fleet of two sim shards gets the
    sim's per-packet injects, one global epoch a window."""
    tr = small_trace(m)
    plat = m.api.Platform([m.api.SimBackend(name="s0", seed=3),
                           m.api.SimBackend(name="s1", seed=4)],
                          specs=m.api.VPC_SPECS)
    res = plat.drive(tr)
    assert res.backend == "sharded"
    assert sum(res.served.values()) == sum(res.injected.values()) \
        == tr.total_pkts
    return drive_obs(res) + [plat.backend.global_epochs]


@pytest.mark.parametrize("scenario", [
    sim_replay_serves_everything, double_replay_identical,
    sim_vs_compute_schedule_and_census_identical,
    churn_removes_tenant_from_backend, sharded_sim_replay],
    ids=lambda f: f.__name__)
def test_trace_driver_on_sim_like_jax(scenario):
    same(scenario)


def portability_on(m, kind):
    """``benchmarks/bench_scenarios.py``'s portability trace on its sim or
    two-shard sim platform (as ``chip_smoke.trace_path`` drives them)."""
    w = m.workloads
    trace = w.generate("portability", seed=5, epochs=6, n_tenants=6,
                       arrival=w.constant(1.0), churn_frac=0.25)
    plat = m.api.Platform(
        m.api.SimBackend(seed=3) if kind == "sim" else
        [m.api.SimBackend(name="p0", seed=1),
         m.api.SimBackend(name="p1", seed=2)], specs=m.api.VPC_SPECS)
    res = plat.drive(trace)
    assert res.backend == kind
    assert res.schedule_fingerprint == "f1a89120f28456dc"
    assert sum(res.served.values()) == trace.total_pkts
    return drive_obs(res)


@pytest.mark.parametrize("kind", ["sim", "sharded"])
def test_portability_trace_on_sim_platforms_like_jax(kind):
    same(portability_on, kind)


@pytest.mark.invariants
def test_i_trace_catches_divergence_and_mismatch_like_jax():
    """``TestTraceInvariant``'s two failing cases, on the port's replays."""
    m = PORT
    r1, r2 = (m.api.Platform(m.api.SimBackend(seed=3),
                             specs=m.api.VPC_SPECS).drive(small_trace(m))
              for _ in range(2))
    r2.served[next(iter(r2.served))] += 1
    with pytest.raises(m.inv.InvariantViolation, match="I-TRACE"):
        m.inv.check_trace(r1, r2, "test/diverged")
    r3 = m.api.Platform(m.api.SimBackend(seed=3), specs=m.api.VPC_SPECS
                        ).drive(small_trace(m, seed=8))
    with pytest.raises(m.inv.InvariantViolation, match="different traces"):
        m.inv.check_trace(r1, r3, "test/mismatch")


# ============================================ resilience and figures ==
def _load(name: str, path, port: bool):
    """Load a file of the repo as a module; with ``port`` every
    ``repro.`` import in it is re-pointed to ``repro_torch.``."""
    src = path.read_text()
    if port:
        src = src.replace("from repro.", "from repro_torch.")
        assert "repro." not in src.replace("repro_torch.", "")
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def test_resilience_scenario_equals_the_benchmarks():
    """The kill-1-of-4 scenario at smoke size (10 chunks, crash at epoch 7,
    seed 42): ``chip_smoke.py``'s port-side copy on the port's sim fleet
    gives the JAX package's normalized report, and its fingerprint is the
    one ``BENCH_resilience.json`` records."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        from benchmarks import bench_resilience
    finally:
        sys.path.remove(str(ROOT))
    want = bench_resilience._run_once(10, 7, 42)
    got = chip_smoke.resilience_run(10, 7, 42)
    assert got == want
    fp = chip_smoke.resilience_fingerprint(got)
    assert fp == bench_resilience._fingerprint(want) == "f7fcfdb31e0a86eb"
    acc = chip_smoke.resilience_acceptance(got, got)
    assert acc["pass"], acc


@pytest.mark.parametrize("fig", ["fig16_parallelism", "fig17_drf_autoscale"])
def test_paper_figure_through_the_port_equals_jax(fig):
    """``benchmarks/figures.py`` run once as it is and once with its
    imports re-pointed to the port: the figure's dict is equal."""
    path = ROOT / "benchmarks" / "figures.py"
    want = getattr(_load("figures_jax", path, port=False), fig)()
    got = getattr(_load("figures_port", path, port=True), fig)()
    assert got == want
    assert len(got) > 3
