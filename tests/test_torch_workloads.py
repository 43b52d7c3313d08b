"""The PyTorch port's workload plane held against the JAX package's.

Arrival processes, populations, generated traces and compiled fault plans
must give the JAX package's numbers and fingerprints; the driver's wire
batches and prompts must be byte-identical; and the portability trace of
``benchmarks/bench_scenarios.py`` replayed on the port's compute,
compute-stream and sharded-compute platforms (``device="cpu"``) must give
the schedule fingerprint recorded in ``BENCH_scenarios.json``
(``f1a89120f28456dc``), the JAX package's census and injects, and the
same served counts and output bits as the JAX package's compute platform.
"""
from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro.workloads as jw
from repro.analysis import invariants as jinv

import repro_torch.api as tapi
import repro_torch.workloads as tw
from repro_torch.analysis import invariants as tinv
from repro_torch.workloads.driver import _derived_seed

ROOT = Path(__file__).resolve().parents[1]
W = {"jax": jw, "torch": tw}


def portability(w):
    """The portability trace as ``bench_scenarios._portability`` builds it
    in smoke mode (6 epochs)."""
    return w.generate("portability", seed=5, epochs=6, n_tenants=6,
                      arrival=w.constant(1.0), churn_frac=0.25)


def portability_fingerprint() -> str:
    rec = json.loads((ROOT / "BENCH_scenarios.json").read_text())
    return rec["portability"]["substrates"]["compute"][
        "schedule_fingerprint"]


SHAPES = {
    "diurnal": lambda w: w.diurnal(mean=4.0, period=8),
    "flash": lambda w: w.constant(10) + w.flash_crowd(at=4, magnitude=20,
                                                      width=2),
    "onoff": lambda w: w.onoff(rate_on=7, on=2, off=2) * 1.5,
    "mmpp": lambda w: w.mmpp([1.0, 50.0], dwell=3, horizon=32, seed=4),
    "clip": lambda w: w.clip(w.diurnal(mean=30.0, period=12) * 2, hi=40.0),
}


# ================================================================ arrivals ==
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_arrival_rates_and_samples_equal_the_jax_package(shape):
    j, t = SHAPES[shape](jw), SHAPES[shape](tw)
    assert [t(e) for e in range(40)] == [j(e) for e in range(40)]
    draws = {}
    for name, w, a in (("jax", jw, j), ("torch", tw, t)):
        rng = random.Random(9)
        draws[name] = [w.sample_poisson(rng, a(e)) for e in range(40)]
    assert draws["jax"] == draws["torch"]


def test_population_equals_the_jax_package():
    assert tw.zipf_weights(16) == jw.zipf_weights(16)
    assert tw.pareto_sizes(random.Random(3), 200, lo=200, hi=1500) == \
        jw.pareto_sizes(random.Random(3), 200, lo=200, hi=1500)
    assert tw.dag_mix(random.Random(5), 40) == jw.dag_mix(random.Random(5), 40)
    assert tw.VPC_CHAIN_MIX == jw.VPC_CHAIN_MIX
    assert tw.SERVE_CHAIN_MIX == jw.SERVE_CHAIN_MIX


# =================================================================== trace ==
TRACES = {
    "portability": portability,
    "small": lambda w: w.generate("small", seed=7, epochs=8, n_tenants=5,
                                  arrival=w.diurnal(mean=4.0, period=8),
                                  churn_frac=0.4),
    "churnfail": lambda w: w.generate("churnfail", seed=37, epochs=12,
                                      n_tenants=10, arrival=w.constant(6.0),
                                      churn_frac=0.5),
    "crowd": lambda w: w.generate(
        "crowd", seed=11, epochs=10, n_tenants=4,
        arrival=lambda i, rng: (w.flash_crowd(at=3, magnitude=30)
                                if i == 0 else w.constant(2.0))),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_and_fault_plan_fingerprints_equal_the_jax_package(name):
    j, t = TRACES[name](jw), TRACES[name](tw)
    assert t.fingerprint() == j.fingerprint()
    assert t.to_dict() == j.to_dict()
    assert tw.Trace.from_dict(t.to_dict()).fingerprint() == t.fingerprint()
    assert [t.census(e) for e in range(t.epochs)] == \
        [j.census(e) for e in range(j.epochs)]
    assert t.fault_plan().fingerprint() == j.fault_plan().fingerprint()


# =============================================================== synthesis ==
@pytest.mark.parametrize("epoch,tenant,pkts", [(0, "t000", 1), (3, "t002", 7),
                                               (5, "t005", 33)])
def test_wire_batches_and_prompts_byte_equal(epoch, tenant, pkts):
    jt, tt = portability(jw), portability(tw)
    jd = jw.TraceDriver(japi.Platform(japi.ComputeBackend()))
    td = tw.TraceDriver(tapi.Platform(tapi.ComputeBackend(device="cpu")))
    jb = jd._wire_state(jt, epoch, jt.tenant(tenant), pkts)
    tb = td._wire_state(tt, epoch, tt.tenant(tenant), pkts)
    assert set(jb) == set(tb) == {"headers", "payload"}
    for k in jb:
        assert tb[k].device.type == "cpu"        # host-resident packets
        assert np.asarray(jb[k]).tobytes() == tb[k].numpy().tobytes()
        assert tuple(tb[k].shape) == np.asarray(jb[k]).shape
    assert _derived_seed(5, epoch, tenant) == \
        jw.driver._derived_seed(5, epoch, tenant)
    for i in range(3):
        assert jd._prompt(jt, epoch, tenant, i).tobytes() == \
            td._prompt(tt, epoch, tenant, i).tobytes()


def test_default_vpc_params_equal_the_jax_package():
    jp = jw.default_vpc_params()
    tp = tw.default_vpc_params("cpu")
    for a, b in zip(jp["firewall"]["rules"], tp["firewall"]["rules"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for k in ("key", "nonce"):
        np.testing.assert_array_equal(np.asarray(jp["chacha20"][k]),
                                      tp["chacha20"][k].numpy())
    assert tp["nat"] == jp["nat"]


# ================================================================== replay ==
def port_platform(kind):
    cpu = {"device": "cpu"}
    if kind == "compute":
        return tapi.Platform(tapi.ComputeBackend(**cpu),
                             specs=tapi.VPC_SPECS)
    if kind == "compute_stream":
        return tapi.Platform(tapi.ComputeBackend(stream=True, **cpu),
                             specs=tapi.VPC_SPECS)
    return tapi.Platform([tapi.ComputeBackend(name="c0", **cpu),
                          tapi.ComputeBackend(name="c1", stream=True, **cpu)],
                         specs=tapi.VPC_SPECS)


_JAX_COMPUTE: dict = {}


def jax_compute_replay():
    """The JAX package's compute platform on the portability trace (shared
    by the parametrisations)."""
    if not _JAX_COMPUTE:
        res = japi.Platform(japi.ComputeBackend(),
                            specs=japi.VPC_SPECS).drive(portability(jw))
        _JAX_COMPUTE["res"] = res
    return _JAX_COMPUTE["res"]


@pytest.mark.parametrize("kind", ["compute", "compute_stream",
                                  "sharded_compute"])
def test_portability_trace_replays_on_the_port(kind):
    trace = portability(tw)
    res = port_platform(kind).drive(trace)
    want = jax_compute_replay()
    assert res.backend == kind
    assert res.trace_fingerprint == want.trace_fingerprint
    assert res.schedule_fingerprint == portability_fingerprint() \
        == want.schedule_fingerprint == "f1a89120f28456dc"
    assert res.census == want.census
    assert res.injected == want.injected
    assert res.served == want.served
    assert sum(res.served.values()) == trace.total_pkts
    for name, jtr in want.report.tenants.items():
        touts = res.report.tenants[name].outputs
        assert len(touts) == len(jtr.outputs)
        for jo, to in zip(jtr.outputs, touts):
            for k in ("allow", "headers", "payload"):
                np.testing.assert_array_equal(np.asarray(jo[k]),
                                              to[k].numpy())


def test_double_replay_identical_and_i_trace_clean():
    tr = TRACES["small"](tw)
    r1 = port_platform("compute_stream").drive(tr)
    r2 = port_platform("compute_stream").drive(tr)
    assert r1.schedule_fingerprint == r2.schedule_fingerprint
    assert r1.census == r2.census and r1.counters() == r2.counters()
    tinv.check_trace(r1, r2, "test/small")       # must not raise
    r2.served[next(iter(r2.served))] += 1
    with pytest.raises(tinv.InvariantViolation, match="I-TRACE"):
        tinv.check_trace(r1, r2, "test/diverged")
    j1 = japi.Platform(japi.ComputeBackend(),
                       specs=japi.VPC_SPECS).drive(TRACES["small"](jw))
    assert j1.counters() == r1.counters()
    jinv.check_trace(j1, j1, "test/jax")


def test_churn_removes_tenant_from_backend():
    tr = tw.Trace("churn", seed=1, epochs=4, tenants=[
        tw.TraceTenant("stay", pkt_bytes=500),
        tw.TraceTenant("brief", pkt_bytes=500, join_epoch=1,
                       leave_epoch=3)],
        events=[(0, "stay", 2), (1, "brief", 2), (3, "stay", 1)])
    plat = port_platform("sharded_compute")
    res = plat.drive(tr)
    assert "brief" not in plat.tenants and "stay" in plat.tenants
    assert res.census[1] == ["brief", "stay"]
    assert res.census[3] == ["stay"]
    assert res.served == {"stay": 3, "brief": 2}


def test_unknown_backend_rejected():
    class Weird:
        pass

    plat = port_platform("compute")
    plat.backend = Weird()
    with pytest.raises(TypeError, match="classify"):
        tw.TraceDriver(plat).kind
