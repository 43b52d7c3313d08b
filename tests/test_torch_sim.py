"""The port's simulated sNIC substrate held against the JAX package's.

``core/{sim,regions,snic,distributed}.py`` and ``api/sim_backend.py`` are
host Python on seeded ``random.Random`` streams in both packages, so the
same scenario on the same seeds must give *equal* observations, not close
ones: every float of every ``FlowStats``, ``PlatformReport`` and launch
result, compared exactly.  Each case runs one scenario twice, on a
namespace of the JAX package's modules and on one of the port's, keeps the
reference test's own assertions inside the scenario (so both packages pass
them), and compares the two runs' observations.

Replayed here: the 36 cases of ``tests/test_core.py``, the sim cases of
``tests/test_api.py::TestCrossSubstrate``, ``tests/test_invariants.py::
TestSimSanitized`` (with ``REPRO_SANITIZE=1``) and ``tests/test_sched.py::
TestSimSubstrateFairness``.  The fleet cases are in
``test_torch_sim_fleet.py``, the KV store in ``test_torch_kv_store.py``;
both import the helpers below.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------- helpers --
class Pkg:
    """One package's modules under the same attribute names."""

    def __init__(self, name: str):
        self.name = name
        imp = importlib.import_module
        self.api = imp(f"{name}.api")
        self.core = imp(f"{name}.core")
        self.sim = imp(f"{name}.core.sim")
        self.regions = imp(f"{name}.core.regions")
        self.distributed = imp(f"{name}.core.distributed")
        self.consolidation = imp(f"{name}.core.consolidation")
        self.inv = imp(f"{name}.analysis.invariants")
        self.faults = imp(f"{name}.faults")
        self.workloads = imp(f"{name}.workloads")
        self.kv = imp(f"{name}.serving.kv_store")

    @property
    def is_port(self) -> bool:
        return self.name == "repro_torch"

    def compute(self, **kw):
        """A compute backend; the port's on the CPU."""
        if self.is_port:
            kw.setdefault("device", "cpu")
        return self.api.ComputeBackend(**kw)

    def tensor(self, a):
        """A numpy array as this package's array type (same bits)."""
        a = np.array(a, copy=True)
        if self.is_port:
            return torch.from_numpy(a)
        import jax.numpy as jnp
        return jnp.asarray(a)

    def vpc_params(self):
        """The mixed-fleet test's VPC params (``make_rules(8, seed=2)``, key
        ``arange(8)``, nonce ``arange(3)``) for this package."""
        from repro.serving.vpc import make_rules
        return {"firewall": {"rules": tuple(self.tensor(x) for x in
                                            make_rules(8, seed=2))},
                "nat": {"nat_ip": 0x0A000001},
                "chacha20": {"key": self.tensor(np.arange(8, dtype=np.uint32)),
                             "nonce": self.tensor(np.arange(3,
                                                            dtype=np.uint32))}}

    def packets(self, n: int, seed: int):
        from repro.serving.vpc import make_packets
        return tuple(self.tensor(x) for x in make_packets(n, seed=seed))


REF = Pkg("repro")
PORT = Pkg("repro_torch")


def plain(x, depth: int = 0):
    """An observation as plain, exactly comparable data: dataclasses become
    dicts tagged with their class name, dicts lists of items in key order
    (an output dict's insertion order differs between the packages), enums
    their value, tensors and arrays nested lists, NaN a string (so NaN
    equals NaN)."""
    if depth > 40:
        raise RecursionError("observation nests too deep")
    d = depth + 1
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__class__": type(x).__name__,
                **{f.name: plain(getattr(x, f.name), d)
                   for f in dataclasses.fields(x)}}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return sorted(([plain(k, d), plain(v, d)] for k, v in x.items()),
                      key=lambda kv: repr(kv[0]))
    if isinstance(x, (list, tuple)):
        return [plain(v, d) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v, d) for v in x), key=repr)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().tolist()
    if hasattr(x, "__array__") and not isinstance(x, (bool, int, float, str)):
        return np.asarray(x).tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"no plain form for {type(x).__name__}")


def same(scenario, *args, **kw):
    """Run ``scenario(pkg, *args, **kw)`` on the JAX package and on the
    port; their observations must be equal.  Returns the port's."""
    want = scenario(REF, *args, **kw)
    got = scenario(PORT, *args, **kw)
    assert plain(got) == plain(want)
    return got


def nic_state(nic) -> dict:
    """What one sNIC observed: per-tenant flow stats, its clock, its PR
    count and each region's state and program."""
    return {"stats": nic.stats, "now": nic.sim.now,
            "pr_count": nic.regions.pr_count,
            "regions": [(r.rid, r.state, r.program) for r in nic.regions.regions]}


@pytest.fixture
def sanitize(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert REF.inv.enabled() and PORT.inv.enabled()


# ============================================ tests/test_core.py replayed ==
CORE: dict = {}


def core_case(fn):
    CORE[fn.__name__] = fn
    return fn


def specs8(m):
    return {f"NT{i}": m.core.NTSpec(f"NT{i}", max_gbps=100.0, fixed_ns=100.0)
            for i in range(1, 9)}


def chain_dag(m, uid, tenant, names):
    return m.core.NTDag(uid, tenant, ((tuple(names),),))


def mk_snic(m, sim, mode="snic", **kw):
    kw.setdefault("enable_drf", False)
    kw.setdefault("enable_autoscale", False)
    return m.core.SNIC(sim, m.core.SNICConfig(mode=mode, **kw), specs8(m))


# ---------------------------------------------------------- EventSim --
@core_case
def eventsim_idle_window_advances_clock(m):
    sim = m.core.EventSim()
    fired = []
    sim.at(100.0, fired.append, "late")
    out = [sim.run(until_ns=50.0), sim.now, sim.run(until_ns=30.0), sim.now,
           sim.run(until_ns=1000.0), list(fired), sim.now]
    assert out == [0, 50.0, 0, 50.0, 1, ["late"], 1000.0]
    return out


@core_case
def eventsim_empty_sim_advances_to_horizon(m):
    sim = m.core.EventSim()
    out = [sim.run(until_ns=200.0), sim.now]
    assert out == [0, 200.0]
    return out


@core_case
def eventsim_infinite_horizon_stops_at_last_event(m):
    sim = m.core.EventSim()
    sim.at(7.0, lambda: None)
    sim.run()
    assert sim.now == 7.0
    return sim.now


@core_case
def eventsim_max_events_budget_leaves_clock_at_last_processed(m):
    sim = m.core.EventSim()
    for t in (10.0, 20.0, 30.0):
        sim.at(t, lambda: None)
    out = [sim.run(until_ns=100.0, max_events=1), sim.now]
    out += [sim.run(until_ns=100.0), sim.now]
    assert out == [1, 10.0, 2, 100.0]
    return out


# --------------------------------------------------------------- DRF --
@core_case
def drf_classic_two_tenant(m):
    res = m.core.drf_allocate({"A": {"cpu": 10, "mem": 40},
                               "B": {"cpu": 30, "mem": 10}},
                              {"cpu": 9, "mem": 18})
    assert res.alloc["A"]["cpu"] == pytest.approx(3, abs=0.05)
    assert res.alloc["B"]["cpu"] / 3 == pytest.approx(2, abs=0.05)
    assert res.dominant["A"] == "mem" and res.dominant["B"] == "cpu"
    return res


@core_case
def drf_weighted(m):
    res = m.core.drf_allocate({"A": {"bw": 100.0}, "B": {"bw": 100.0}},
                              {"bw": 90.0}, weights={"A": 2.0, "B": 1.0})
    assert res.alloc["A"]["bw"] == pytest.approx(60.0, rel=0.02)
    assert res.alloc["B"]["bw"] == pytest.approx(30.0, rel=0.02)
    return res


@core_case
def drf_undemanding_tenant_fully_granted(m):
    res = m.core.drf_allocate({"A": {"bw": 1000.0}, "B": {"bw": 1.0}},
                              {"bw": 100.0})
    assert res.alloc["B"]["bw"] == pytest.approx(1.0, rel=0.01)
    assert res.alloc["A"]["bw"] <= 100.0
    return res


@core_case
def drf_work_conserving(m):
    res = m.core.drf_allocate({"A": {"bw": 80.0}, "B": {"bw": 80.0}},
                              {"bw": 100.0})
    assert res.alloc["A"]["bw"] + res.alloc["B"]["bw"] == \
        pytest.approx(100.0, rel=0.02)
    return res


@core_case
def drf_multi_resource_nt_dimension(m):
    res = m.core.drf_allocate(
        {"A": {"nt:NT1": 100.0, "ingress": 10.0},
         "B": {"nt:NT2": 100.0, "ingress": 10.0}},
        {"nt:NT1": 100.0, "nt:NT2": 100.0, "ingress": 100.0})
    assert res.scale("A") == pytest.approx(1.0, abs=0.01)
    assert res.scale("B") == pytest.approx(1.0, abs=0.01)
    return [res, res.scale("A"), res.scale("B")]


# -------------------------------------------------------------- vmem --
def vm_obs(vm) -> dict:
    return {"stats": vm.stats, "free": list(vm.free_frames),
            "tables": {t: sorted(pt) for t, pt in vm.tables.items()}}


@core_case
def vmem_on_demand_alloc_and_hit(m):
    vm = m.core.VirtualMemory(8 << 21)
    vm.register("a")
    lat = [vm.access("a", 0, 0.0), vm.access("a", 0, 1.0)]
    assert lat[0] >= 100.0 and vm.resident_pages("a") == 1
    assert lat[1] == pytest.approx(100.0)
    return [lat, vm_obs(vm)]


@core_case
def vmem_isolation(m):
    vm = m.core.VirtualMemory(8 << 21)
    vm.register("a")
    with pytest.raises(PermissionError) as ei:
        vm.access("b", 0, 0.0)
    return str(ei.value)


@core_case
def vmem_oversubscription_swaps_lru(m):
    vm = m.core.VirtualMemory(4 << 21)
    vm.register("a"), vm.register("b")
    lat = [vm.access("a", i, float(i)) for i in range(3)]
    lat.append(vm.access("b", 0, 10.0))
    assert not vm.free_frames
    lat.append(vm.access("b", 1, 11.0))
    assert lat[-1] >= vm.swap_ns and vm.stats.swap_outs == 1
    assert vm.tables["a"][0].swapped
    lat.append(vm.access("a", 0, 12.0))
    assert lat[-1] >= 2 * vm.swap_ns and vm.stats.swap_ins == 1
    return [lat, vm_obs(vm)]


@core_case
def vmem_quota_denies(m):
    vm = m.core.VirtualMemory(8 << 21)
    vm.register("a")
    vm.quota["a"] = 2
    vm.access("a", 0, 0.0), vm.access("a", 1, 0.0)
    with pytest.raises(m.core.OutOfMemory) as ei:
        vm.access("a", 2, 0.0)
    return [str(ei.value), vm_obs(vm)]


@core_case
def vmem_no_remote_space_rejects(m):
    vm = m.core.VirtualMemory(2 << 21, remote_free=lambda: False)
    vm.register("a")
    vm.access("a", 0, 0.0), vm.access("a", 1, 0.0)
    with pytest.raises(m.core.OutOfMemory) as ei:
        vm.access("a", 2, 0.0)
    return [str(ei.value), vm_obs(vm)]


@core_case
def vmem_release_frees(m):
    vm = m.core.VirtualMemory(4 << 21)
    vm.register("a")
    for i in range(4):
        vm.access("a", i, 0.0)
    n = vm.release("a")
    assert n == 4 and len(vm.free_frames) == 4
    return [n, vm_obs(vm)]


# ----------------------------------------------------------- regions --
@core_case
def regions_bitstream_enumeration(m):
    progs = m.core.enumerate_programs([chain_dag(m, 1, "u1",
                                                 ("NT1", "NT2", "NT3"))],
                                      specs8(m), region_slots=2)
    names = {p.names for p in progs}
    assert ("NT1", "NT2") in names and ("NT2", "NT3") in names
    assert ("NT1", "NT2", "NT3") not in names and ("NT1",) in names
    return progs


@core_case
def regions_victim_cache_revival_skips_pr(m):
    PAPER, MS = m.core.PAPER, m.sim.MS
    rm = m.regions.RegionManager(2, 4, specs8(m), pr_ns=PAPER.PR_NS)
    p1 = m.core.ChainProgram(("NT1", "NT2"))
    r1 = rm.launch(p1, 0.0)
    assert r1.did_pr and r1.ready_ns == PAPER.PR_NS
    rm.finish_pr(r1.region)
    rm.deschedule(r1.region, 1.0 * MS)
    r2 = rm.launch(p1, 2.0 * MS)
    assert r2.victim_revived and not r2.did_pr
    assert r2.ready_ns == 2.0 * MS and rm.pr_count == 1
    return [r1, r2, rm.pr_count]


@core_case
def regions_policy_ladder_free_then_victim_then_ctx(m):
    rm = m.regions.RegionManager(2, 4, specs8(m), pr_ns=1000.0)
    CP = m.core.ChainProgram
    a = rm.launch(CP(("NT1",)), 0.0); rm.finish_pr(a.region)
    b = rm.launch(CP(("NT2",)), 0.0); rm.finish_pr(b.region)
    rm.deschedule(b.region, 10.0)
    c = rm.launch(CP(("NT3",)), 20.0)
    assert c.region is b.region and not c.context_switched
    rm.finish_pr(c.region)
    d = rm.launch(CP(("NT4",)), 30.0)
    assert d.context_switched
    return [a, b, c, d, rm.pr_count]


@core_case
def regions_no_context_switch_flag(m):
    rm = m.regions.RegionManager(1, 4, specs8(m), pr_ns=1000.0)
    a = rm.launch(m.core.ChainProgram(("NT1",)), 0.0); rm.finish_pr(a.region)
    b = rm.launch(m.core.ChainProgram(("NT2",)), 1.0,
                  allow_context_switch=False)
    assert b.region is None
    return [a, b]


@core_case
def regions_load_balanced_pick(m):
    rm = m.regions.RegionManager(2, 4, specs8(m), pr_ns=0.0)
    a = rm.launch(m.core.ChainProgram(("NT1",)), 0.0); rm.finish_pr(a.region)
    b = rm.launch(m.core.ChainProgram(("NT1",)), 0.0); rm.finish_pr(b.region)
    a.region.instances[0].busy_until_ns = 500.0
    pick = rm.find_program(("NT1",), now_ns=0.0)
    assert pick is b.region
    return [pick, a, b]


# --------------------------------------------------------- scheduler --
@core_case
def scheduler_chain_single_sched_visit(m):
    sim = m.core.EventSim()
    nic = mk_snic(m, sim)
    names = ("NT1", "NT2", "NT3", "NT4")
    nic.deploy([chain_dag(m, 1, "u1", names)],
               programs=[m.core.ChainProgram(names)])
    sim.run(m.core.PAPER.PR_NS + 1)
    done = []
    nic.done_hook = done.append
    nic.inject("u1", 1, 1000)
    sim.run(sim.now + 1 * m.sim.MS)
    assert len(done) == 1 and done[0].sched_visits == 1
    return [done, nic_state(nic)]


@core_case
def scheduler_panic_vs_chain_latency_under_load(m):
    res = {}
    for mode in ("snic", "panic"):
        sim = m.core.EventSim()
        nic = mk_snic(m, sim, mode=mode, credits=2)
        names = ("NT1", "NT2", "NT3", "NT4", "NT5")
        nic.deploy([chain_dag(m, 1, "u1", names)],
                   programs=[m.core.ChainProgram(names)])
        sim.run(m.core.PAPER.PR_NS + 1)
        m.sim.poisson_source(sim, rate_gbps=90.0, mean_bytes=1500,
                             tenant="u1", dag_uid=1, sink=nic.inject, seed=3,
                             until_ns=sim.now + 2 * m.sim.MS)
        sim.run(sim.now + 4 * m.sim.MS)
        st = nic.stats["u1"]
        res[mode] = (st.mean_latency_us(), st.pkts_done, nic_state(nic))
    assert res["panic"][0] > res["snic"][0]
    return res


@core_case
def scheduler_fork_join_parallelism(m):
    sim = m.core.EventSim()
    nic = mk_snic(m, sim)
    slow = {n: m.core.NTSpec(n, max_gbps=10.0, fixed_ns=5000.0)
            for n in ("NT1", "NT2", "NT3", "NT4")}
    nic.specs = slow
    nic.regions.specs = slow
    par = m.core.NTDag(1, "u1", ((("NT1", "NT2"), ("NT3",)), (("NT4",),)))
    ser = chain_dag(m, 2, "u1", ("NT1", "NT2", "NT3", "NT4"))
    nic.deploy([par, ser])
    sim.run(m.core.PAPER.PR_NS * 10)
    lat = {}
    for uid, tag in ((1, "par"), (2, "ser")):
        done = []
        nic.done_hook = done.append
        nic.inject("u1", uid, 1000)
        sim.run(sim.now + 5 * m.sim.MS)
        assert done, tag
        lat[tag] = done[-1].latency_ns
    assert lat["par"] < lat["ser"]
    return [lat, nic_state(nic)]


@core_case
def scheduler_skip_support(m):
    sim = m.core.EventSim()
    nic = mk_snic(m, sim)
    nic.deploy([chain_dag(m, 1, "u1", ("NT1", "NT2", "NT3")),
                chain_dag(m, 2, "u1", ("NT1", "NT3"))],
               programs=[m.core.ChainProgram(("NT1", "NT2", "NT3"))])
    sim.run(m.core.PAPER.PR_NS + 1)
    done = []
    nic.done_hook = done.append
    nic.inject("u1", 2, 500)
    sim.run(sim.now + 1 * m.sim.MS)
    assert len(done) == 1 and done[0].sched_visits == 1
    return [done, nic_state(nic)]


@core_case
def scheduler_throughput_vs_credits(m):
    tput, states = {}, {}
    for credits in (1, 8):
        sim = m.core.EventSim()
        nic = mk_snic(m, sim, credits=credits)
        nic.deploy([chain_dag(m, 1, "u1", ("NT1",))])
        sim.run(m.core.PAPER.PR_NS + 1)
        t0 = sim.now
        m.sim.poisson_source(sim, rate_gbps=98.0, mean_bytes=1000,
                             tenant="u1", dag_uid=1, sink=nic.inject, seed=1,
                             until_ns=t0 + 3 * m.sim.MS)
        sim.run(t0 + 3 * m.sim.MS)
        tput[credits] = nic.stats["u1"].gbps(sim.now - t0)
        states[credits] = nic_state(nic)
    assert tput[8] > tput[1] * 1.2 and tput[8] > 80.0
    return [tput, states]


@core_case
def scheduler_on_demand_launch_buffers_first_packets(m):
    sim = m.core.EventSim()
    nic = mk_snic(m, sim)
    nic.deploy([chain_dag(m, 1, "u1", ("NT1", "NT2"))], prelaunch=False)
    done = []
    nic.done_hook = done.append
    nic.inject("u1", 1, 1000)
    sim.run(sim.now + m.core.PAPER.PR_NS * 3)
    assert len(done) == 1 and done[0].latency_ns >= m.core.PAPER.PR_NS
    return [done, nic_state(nic)]


# ------------------------------------------------------ consolidation --
@core_case
def consolidation_sum_of_peaks_geq_aggregate(m):
    rep = m.core.analyze(m.consolidation.synthetic_trace(8, 512, seed=1))
    assert rep.sum_of_peaks >= rep.peak_of_aggregate and rep.savings > 1.3
    return rep


@core_case
def consolidation_rack_hierarchy(m):
    r = m.core.rack_analysis(m.consolidation.synthetic_trace(64, 512, seed=2),
                             rack_size=8)
    assert (r["sum_of_endpoint_peaks"] >= r["sum_of_rack_peaks"]
            >= r["peak_of_aggregate"])
    assert r["global_saving"] > r["rack_saving"] > 1.0
    return r


@core_case
def consolidation_fb_trace_quantiles(m):
    loads = m.consolidation.fb_kv_load_trace(4, 4000, seed=3)
    med = float(np.median(loads))
    assert 18.0 < med < 30.0
    return [med, loads]


@core_case
def consolidation_rack_analysis_uneven_tail_rack(m):
    loads = np.zeros((5, 4))
    for i in range(5):
        loads[i, i % 4] = 10.0 * (i + 1)
    r = m.core.rack_analysis(loads, rack_size=2)
    assert r["sum_of_rack_peaks"] == pytest.approx(110.0)
    assert r["sum_of_endpoint_peaks"] == pytest.approx(150.0)
    tail = m.core.rack_analysis(loads[4:5], rack_size=2)
    assert tail["sum_of_rack_peaks"] == pytest.approx(50.0)
    return [r, tail]


@core_case
def consolidation_onoff_source_resumes_from_boundary_aligned_off(m):
    sim = m.core.EventSim()
    period = 800_000.0
    sim.run(5_080_001.0)
    got = []
    m.sim.onoff_source(sim, tenant="t", dag_uid=1,
                       sink=lambda *a: got.append((sim.now, a)),
                       peak_gbps=10.0, duty=0.5, period_ns=period,
                       phase=0.25, until_ns=sim.now + 4 * m.sim.MS)
    sim.run(sim.now + 4 * m.sim.MS)
    assert got, "source never emitted"
    for t, _ in got:
        assert ((t + 0.25 * period) % period) < 0.5 * period
    return got


@core_case
def consolidation_rack_analysis_rejects_bad_inputs(m):
    errs = []
    for bad, loads in ((0, np.ones((4, 8))), (-1, np.ones((4, 8))),
                       (2.5, np.ones((4, 8))), (2, np.ones(8)),
                       (2, np.ones((0, 8)))):
        with pytest.raises(ValueError, match="rack_size|matrix") as ei:
            m.core.rack_analysis(loads, rack_size=bad)
        errs.append(str(ei.value))
    return errs


# -------------------------------------------------------------- rack --
@core_case
def distributed_offload_and_migrate_back(m):
    sim = m.core.EventSim()
    PR, MS = m.core.PAPER.PR_NS, m.sim.MS
    rack = m.core.make_rack(sim, 2, specs8(m), cfg_kw=dict(
        n_regions=1, region_slots=4, enable_drf=False,
        enable_autoscale=False))
    a, b = rack.snics
    a.deploy([chain_dag(m, 1, "u1", ("NT1",))])
    sim.run(PR + 1)
    a.inject("u1", 1, 500)
    sim.run(sim.now + 1 * MS)
    a.deploy([chain_dag(m, 2, "u2", ("NT2",))], prelaunch=False)
    done = []
    a.done_hook = done.append
    b.done_hook = done.append
    a.inject("u2", 2, 800)
    sim.run(sim.now + PR * 3)
    assert done and done[0].hops == 1
    assert rack.migrations and rack.migrations[0][1] == "snic0"
    return [done, rack.migrations, nic_state(a), nic_state(b)]


@core_case
def distributed_directed_migrate_to_stays_put(m):
    sim = m.core.EventSim()
    PR, MS = m.core.PAPER.PR_NS, m.sim.MS
    rack = m.core.make_rack(sim, 3, specs8(m), cfg_kw=dict(
        n_regions=2, region_slots=4, enable_drf=False,
        enable_autoscale=False))
    a, _b, c = rack.snics
    a.deploy([chain_dag(m, 1, "u1", ("NT1",))])
    sim.run(PR + 1)
    assert rack.migrate_to(a, c, 1)
    done = []
    c.done_hook = done.append
    sim.run(sim.now + PR + 1)
    a.inject("u1", 1, 500)
    sim.run(sim.now + 1 * MS)
    assert done and done[0].hops == 1
    assert rack.migrations[-1][1:3] == (a.cfg.name, c.cfg.name)
    sim.run(sim.now + 20 * MS)
    assert 1 in a.remote_dags
    return [done, rack.migrations, sorted(a.remote_dags), nic_state(c)]


@core_case
def distributed_remote_memory_pooling(m):
    sim = m.core.EventSim()
    rack = m.core.make_rack(sim, 2, specs8(m), cfg_kw=dict(
        enable_drf=False, enable_autoscale=False))
    a = rack.snics[0]
    a.vmem.n_frames = 2
    a.vmem.free_frames = [1, 0]
    a.vmem.register("x")
    lat = [a.vmem.access("x", 0, 0.0), a.vmem.access("x", 1, 0.0),
           a.vmem.access("x", 2, 1.0)]
    assert lat[2] >= a.vmem.swap_ns
    return [lat, vm_obs(a.vmem)]


@pytest.mark.parametrize("case", list(CORE))
def test_core_case_matches_jax(case):
    """One case of ``tests/test_core.py`` on both packages: the reference's
    assertions hold on each, and the observations are equal."""
    same(CORE[case])


def test_every_core_case_is_replayed():
    """Each test of ``tests/test_core.py`` has its replay here."""
    import ast
    tree = ast.parse((ROOT / "tests" / "test_core.py").read_text())
    ref = [f"{cls.name[4:].lower()}_{fn.name[5:]}"
           for cls in tree.body if isinstance(cls, ast.ClassDef)
           for fn in cls.body
           if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")]
    assert sorted(ref) == sorted(CORE)


# ============================================== the sim backend, api ==
VPC_CHAIN = ("firewall", "nat", "chacha20")


def chain(m, names=VPC_CHAIN):
    expr = m.api.nt(names[0])
    for n in names[1:]:
        expr = expr >> m.api.nt(n)
    return expr


def sim_backend_stats(m):
    """``tests/test_api.py::TestCrossSubstrate::test_sim_backend_stats``."""
    plat = m.api.Platform(m.api.SimBackend(), specs=m.api.VPC_SPECS)
    dep = plat.tenant("alice", weight=2.0).deploy(chain(m))
    plat.backend.settle()
    dep.source("poisson", rate_gbps=40.0, mean_bytes=1000, seed=1,
               duration_ms=2.0)
    plat.run(duration_ms=2.0)
    rep = plat.report()
    tr = rep["alice"]
    assert tr.pkts_done > 100 and tr.gbps > 10.0
    assert tr.mean_latency_us < 1000.0
    assert tr.p99_latency_us >= tr.mean_latency_us
    return [rep, nic_state(plat.backend.snic)]


def sim_settle_resets_measurement_window(m):
    """``tests/test_api.py::TestCrossSubstrate::
    test_sim_settle_resets_measurement_window``."""
    plat = m.api.Platform(m.api.SimBackend(), specs=m.api.VPC_SPECS)
    dep = plat.tenant("a").deploy(m.api.nt("firewall"))
    plat.run(duration_ms=1.0)
    plat.backend.settle()
    dep.source("poisson", rate_gbps=20.0, mean_bytes=1000, seed=1,
               duration_ms=2.0)
    plat.run(duration_ms=2.0)
    rep = plat.report()
    assert rep.duration_ns == pytest.approx(2e6, rel=0.01)
    assert rep["a"].gbps > 10.0
    return rep


@pytest.mark.parametrize("scenario", [sim_backend_stats,
                                      sim_settle_resets_measurement_window],
                         ids=lambda f: f.__name__)
def test_sim_backend_matches_jax(scenario):
    same(scenario)


def test_deployment_source_raises_without_a_sim_substrate():
    """``Deployment.source`` attaches traffic only where a backend has
    sources: a compute-only platform still raises, as the JAX package's."""
    for m in (REF, PORT):
        plat = m.api.Platform(m.compute(use_fused=False),
                              specs=m.api.VPC_SPECS)
        dep = plat.tenant("a").deploy(chain(m, ("firewall", "nat")),
                                      params=m.vpc_params())
        with pytest.raises(NotImplementedError, match="no traffic sources"):
            dep.source("poisson", rate_gbps=1.0, mean_bytes=1000)


def test_sim_backend_exposes_its_simulator():
    """A fleet treats a shard as event-driven when it has ``sim``: the
    port's SimBackend names its simulator as the JAX package's does, so it
    takes the event path of ``ShardedBackend``."""
    from repro_torch.api.sharded_backend import _is_event
    be = PORT.api.SimBackend()
    assert isinstance(be.sim, PORT.core.EventSim) and _is_event(be)
    assert not _is_event(PORT.compute())


# ====================================== test_invariants.py::TestSimSanitized ==
def sanitized_fairness(m):
    api = m.api
    plat = api.Platform(api.SimBackend(specs=api.VPC_SPECS),
                        specs=api.VPC_SPECS)
    da = plat.tenant("alice", weight=3.0).deploy(chain(m))
    db = plat.tenant("bob", weight=1.0).deploy(chain(m, ("firewall", "nat")))
    for _ in range(200):
        plat.backend.inject("alice", da.uid, 1500)
        plat.backend.inject("bob", db.uid, 1000)
    plat.run(duration_ms=2.0, settle=True)
    rep = plat.report()
    assert rep["alice"].pkts_done > 0
    return [rep, nic_state(plat.backend.snic)]


def sanitized_rack(m):
    api = m.api
    plat = api.Platform(api.SimBackend(specs=api.VPC_SPECS, n_snics=3),
                        specs=api.VPC_SPECS)
    d = plat.tenant("alice").deploy(chain(m, ("firewall", "chacha20")))
    for _ in range(150):
        plat.backend.inject("alice", d.uid, 1200)
    plat.run(duration_ms=2.0, settle=True)
    return [plat.report(), [nic_state(s) for s in plat.backend.snics],
            plat.backend.rack.migrations]


def sanitized_violation_detected(m):
    api = m.api
    be = api.SimBackend(specs=api.VPC_SPECS)
    plat = api.Platform(be, specs=api.VPC_SPECS)
    d = plat.tenant("alice").deploy(api.nt("firewall"))
    for _ in range(10):
        plat.backend.inject("alice", d.uid, 1000)
    plat.run(duration_ms=1.0)
    be.snic.stats["alice"].pkts_done += 1000
    with pytest.raises(m.inv.InvariantViolation) as ei:
        plat.run(duration_ms=0.1)
    assert any(d.rule == "I-PKTS" for d in ei.value.diagnostics)
    return [(d.rule, d.message) for d in ei.value.diagnostics]


@pytest.mark.invariants
@pytest.mark.parametrize("scenario", [sanitized_fairness, sanitized_rack,
                                      sanitized_violation_detected],
                         ids=lambda f: f.__name__)
def test_sanitized_sim_matches_jax(scenario, sanitize):
    """``TestSimSanitized`` with ``REPRO_SANITIZE=1``: the hooks in
    ``SNIC._epoch`` and ``SimBackend.run``/``settle`` audit every epoch in
    both packages, and the runs stay equal."""
    same(scenario)


@pytest.mark.invariants
def test_port_sanitizer_hooks_fire_in_the_sim(sanitize, monkeypatch):
    """The port's sNIC epoch and SimBackend window call the invariant
    checks (counted by wrapping them)."""
    calls = {"snic": 0, "fleet": 0}
    inv = PORT.inv
    for name, key in (("check_snic", "snic"), ("check_fleet", "fleet")):
        orig = getattr(inv, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(inv, name, counted)
    sanitized_fairness(PORT)
    assert calls["snic"] > 10 and calls["fleet"] >= 2


# ============================== test_sched.py::TestSimSubstrateFairness ==
def wdrr_drf_shares_converge_to_weights(m):
    plat = m.api.Platform(m.api.SimBackend(), specs=m.api.VPC_SPECS)
    heavy = plat.tenant("heavy", weight=2.0)
    light = plat.tenant("light", weight=1.0)
    d_h = heavy.deploy(chain(m, ("firewall", "nat")))
    d_l = light.deploy(chain(m, ("firewall", "nat")))
    plat.backend.settle()
    d_h.source("poisson", rate_gbps=300.0, mean_bytes=1000, seed=1,
               duration_ms=4.0)
    d_l.source("poisson", rate_gbps=300.0, mean_bytes=1000, seed=2,
               duration_ms=4.0)
    plat.run(duration_ms=4.0)
    rep = plat.report()
    ratio = rep["heavy"].bytes_done / rep["light"].bytes_done
    assert ratio == pytest.approx(2.0, rel=0.05), ratio
    assert rep["heavy"].drops > 0 and rep["light"].drops > 0
    assert rep["heavy"].extra["weight"] == 2.0
    return [rep, nic_state(plat.backend.snic)]


def test_sim_substrate_fairness_matches_jax():
    """``TestSimSubstrateFairness``: two tenants at 3x the link each; the
    served-byte ratio is 2:1 within 5 % and every float is the JAX
    package's (~100 s a package on the CPU)."""
    same(wdrr_drf_shares_converge_to_weights)


# ========================================================= import guard ==
def test_substrate_imports_pull_in_neither_jax_nor_repro():
    """A fresh interpreter importing the port's api, core and KV store (the
    substrate and everything it reaches) loads no ``jax`` and no module of
    the JAX package."""
    code = (
        "import json, sys\n"
        "import repro_torch.api, repro_torch.core\n"
        "import repro_torch.serving.kv_store\n"
        "from repro_torch.api import SimBackend\n"
        "SimBackend().run(duration_ms=0.01)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
