"""The PyTorch port's batch runtime held against the JAX package's.

The scenarios of ``tests/test_compute_runtime.py::TestComputeRuntime`` are
replayed on both packages with the same numpy-drawn packets and parameters
(``device="cpu"`` for the port).  Outputs, ``dispatch_log`` and
``stats["traces"]`` must be identical; the arithmetic is integer, so
outputs compare exactly.  With ``use_fused=True`` the JAX package runs its
Pallas megakernel in interpret mode and the port its plain fused version.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.api as japi
from repro.analysis import verifier as jverifier
from repro.core.nt import NTDag as JNTDag
from repro.core.nt import NTSpec as JNTSpec
from repro.serving import vpc as jvpc

import repro_torch.api as tapi
from repro_torch.analysis import verifier as tverifier
from repro_torch.api.compute_backend import _pad_to
from repro_torch.convert import params_from_numpy
from repro_torch.core.nt import NTDag as TNTDag
from repro_torch.core.nt import NTSpec as TNTSpec

RULES = tuple(np.array(x) for x in jvpc.make_rules(32, seed=2))
KEY = np.arange(8, dtype=np.uint32) * 3 + 1
NONCE = np.arange(3, dtype=np.uint32) + 7
WIRE = (5 + 16) * 4


def params_np(**chacha):
    return {"firewall": {"rules": RULES}, "nat": {"nat_ip": 0x0A000001},
            "chacha20": {"key": KEY, "nonce": NONCE, **chacha}}


def jax_params(p):
    out = {k: dict(v) for k, v in p.items()}
    out["firewall"]["rules"] = tuple(jnp.asarray(x) for x in RULES)
    out["chacha20"]["key"] = jnp.asarray(KEY)
    out["chacha20"]["nonce"] = jnp.asarray(NONCE)
    return out


def platform(api, tenants, params, **kw):
    """A Platform of ``api`` with one VPC deployment per tenant."""
    if api is tapi:
        kw = {"device": "cpu", **kw}
        p = params_from_numpy(params, "cpu")
    else:
        p = jax_params(params)
    plat = api.Platform(api.ComputeBackend(**kw), specs=api.VPC_SPECS)
    dag = api.nt("firewall") >> api.nt("nat") >> api.nt("chacha20")
    deps = {name: plat.tenant(name, weight=w).deploy(dag, params=p)
            for name, w in tenants}
    return plat, deps


def feed(api, dep, n, seed, **extra):
    """Inject ``n`` numpy-drawn packets (same bits in both packages)."""
    conv = jnp.asarray if api is japi else torch.from_numpy
    h, p = (np.array(x) for x in jvpc.make_packets(n, seed=seed))
    dep.inject(headers=conv(h), payload=conv(p),
               **{k: conv(v) for k, v in extra.items()})
    return h, p


#: JAX-side runs shared by the parametrisations that differ only on the
#: port's side (each JAX bucket costs seconds of XLA compile on the CPU):
#: key -> (platform, snapshot of what the comparison reads)
_JAX_RUNS: dict = {}


def snapshot(plat) -> dict:
    rep = plat.report()
    return {"tenants": {n: (list(tr.outputs), tr.pkts_done, tr.bytes_done)
                        for n, tr in rep.tenants.items()},
            "log": list(plat.backend.dispatch_log),
            "stats": dict(plat.backend.stats)}


def replay(script, tenants=(("t", 1.0),), params=None, jax_kw=None,
           port_kw=None, key=None, stats=("traces", "dispatches",
                                          "fused_dispatches", "batches",
                                          "coalesced_batches", "runs")):
    """Run ``script(api, plat, deps)`` on both packages and compare
    outputs, dispatch logs and ``stats``.  Returns the port's platform."""
    params = params or params_np()
    if key not in _JAX_RUNS or key is None:
        jplat = platform(japi, tenants, params, **(jax_kw or {}))
        script(japi, *jplat)
        _JAX_RUNS[key] = (jplat[0], snapshot(jplat[0]))
    want = _JAX_RUNS[key][1]
    tplat = platform(tapi, tenants, params, **(port_kw or jax_kw or {}))
    script(tapi, *tplat)
    got = snapshot(tplat[0])
    assert set(want["tenants"]) == set(got["tenants"])
    for name, (jouts, jpkts, jbytes) in want["tenants"].items():
        touts, tpkts, tbytes = got["tenants"][name]
        assert len(jouts) == len(touts)
        for jo, to in zip(jouts, touts):
            assert set(jo) == set(to)
            for k in jo:
                np.testing.assert_array_equal(np.asarray(jo[k]),
                                              to[k].numpy(), err_msg=k)
        assert (jpkts, jbytes) == (tpkts, tbytes)
    assert want["log"] == got["log"]
    for k in stats:
        assert want["stats"][k] == got["stats"][k], k
    return tplat[0]


# ============================================== replayed runtime scenarios ==
@pytest.mark.parametrize("use_fused", [True, False])
def test_bucket_straddling_sizes_and_trace_count_replayed(use_fused):
    """Sizes on both sides of bucket boundaries, one run per inject (no
    coalescing); traces stay at the number of distinct buckets."""
    sizes = [1, 7, 9] if use_fused else [1, 7, 9, 100, 3, 10, 100, 7, 9]

    def script(api, plat, deps):
        for i, n in enumerate(sizes):
            feed(api, deps["t"], n, seed=i)
            plat.run()

    plat = replay(script, jax_kw={"use_fused": use_fused})
    stats = plat.backend.stats
    assert stats["fused_dispatches"] == (len(sizes) if use_fused else 0)
    assert stats["traces"] == len({tapi.bucket_size(n) for n in sizes})


def test_coalescing_and_wire_bytes_replayed():
    """Pending injects dispatch once and un-coalesce in inject order; Gbps
    counts headers and payload only."""
    def script(api, plat, deps):
        for i, n in enumerate([7, 9, 1]):
            feed(api, deps["t"], n, seed=10 + i)
        plat.run()

    plat = replay(script, jax_kw={"use_fused": False})
    be = plat.backend
    assert be.stats["dispatches"] == 1 and be.stats["coalesced_batches"] == 3
    rep = plat.report()
    tr = rep["t"]
    assert [o["headers"].shape[0] for o in tr.outputs] == [7, 9, 1]
    assert tr.pkts_done == 17 and tr.bytes_done == 17 * WIRE
    assert tr.gbps == pytest.approx(tr.bytes_done * 8 / rep.duration_ns,
                                    rel=1e-6)
    assert rep.extra["compiles"] == be.stats["traces"] == 1


def test_mixed_signature_results_stay_in_inject_order_replayed():
    def script(api, plat, deps):
        for i, n in enumerate([7, 9, 1]):
            extra = {"tag": np.full((n,), i, np.int32)} if i == 1 else {}
            feed(api, deps["t"], n, seed=20 + i, **extra)
        plat.run()

    plat = replay(script, jax_kw={"use_fused": False})
    outs = plat.report()["t"].outputs
    assert plat.backend.stats["dispatches"] == 3
    assert "tag" in outs[1] and "tag" not in outs[0]


def test_custom_nt_falls_back_to_composed_replayed():
    outs = []
    for api, scrub in ((japi, lambda s, p: {"payload": s["payload"]
                                            & jnp.uint32(0xFFFF)}),
                       (tapi, lambda s, p: {"payload": s["payload"] & 0xFFFF})):
        kw = {} if api is japi else {"device": "cpu"}
        be = api.ComputeBackend(use_fused=True, **kw)
        be.register_nt(api.ComputeNT("scrub", scrub, writes=("payload",)))
        spec = JNTSpec("scrub") if api is japi else TNTSpec("scrub")
        plat = api.Platform(be, specs=dict(api.VPC_SPECS, scrub=spec))
        rules = tuple(jnp.asarray(x) for x in RULES) if api is japi \
            else tuple(torch.from_numpy(x) for x in RULES)
        dep = plat.tenant("t").deploy(api.nt("firewall") >> api.nt("scrub"),
                                      params={"firewall": {"rules": rules}})
        feed(api, dep, 16, seed=8)
        plat.run()
        assert be.stats["fused_dispatches"] == 0
        outs.append(np.asarray(plat.report()["t"].outputs[0]["payload"]))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("use_fused", [True, False])
def test_two_tenants_weighted_2_to_1_replayed(use_fused):
    """Weights 2:1 with a quantum of one A batch: WDRR serves A, A, B; the
    port's fused path and composed path both give the JAX outputs."""
    def script(api, plat, deps):
        for b in range(4):
            feed(api, deps["A"], 8, seed=100 + b)
            if b < 2:
                feed(api, deps["B"], 7, seed=200 + b)
        plat.run()

    plat = replay(script, tenants=(("A", 2.0), ("B", 1.0)),
                  jax_kw={"use_fused": False, "quantum_bytes": 8 * WIRE},
                  port_kw={"use_fused": use_fused, "quantum_bytes": 8 * WIRE},
                  key="two_tenants",
                  stats=("traces", "dispatches", "batches",
                         "coalesced_batches", "runs"))
    be = plat.backend
    assert "".join(t for t, _ in be.dispatch_log) == "AABAAB"
    assert be.stats["fused_dispatches"] == \
        (be.stats["dispatches"] if use_fused else 0)


@pytest.mark.parametrize("scalar_ctr", [False, True])
@pytest.mark.parametrize("use_fused", [True, False])
def test_stream_mode_counter_and_state_export_replayed(scalar_ctr, use_fused):
    """Stream-mode ChaCha counters continue across batches (batch runs), and
    a fresh port backend that imports the exported state resumes where an
    uninterrupted JAX backend goes on."""
    params = params_np(stream=True, scalar_ctr=scalar_ctr, counter0=5)

    def script(api, plat, deps):
        for i, n in enumerate([7, 9]):
            feed(api, deps["t"], n, seed=30 + i)
        plat.run()

    key = ("stream", scalar_ctr)
    plat = replay(script, params=params, jax_kw={"use_fused": False},
                  port_kw={"use_fused": use_fused}, key=key, stats=())
    jplat = _JAX_RUNS[key][0]
    (uid,) = plat.backend.deployments
    if jplat.backend.stats["batches"] == 2:     # JAX goes on uninterrupted
        _JAX_RUNS[key + ("export",)] = jplat.backend.export_state(uid)
        feed(japi, jplat.tenants["t"].deployments[0], 9, seed=40)
        jplat.run()
    assert plat.backend.export_state(uid) == _JAX_RUNS[key + ("export",)] \
        == {"chacha20": {"next_ctr": 5 + 7 + 9}}
    resumed, deps = platform(tapi, (("t", 1.0),), params, use_fused=use_fused)
    resumed.backend.import_state(
        deps["t"].uid, {"chacha20": {"next_ctr": np.asarray(21)}})
    feed(tapi, deps["t"], 9, seed=40)
    resumed.run()
    jout = jplat.report()["t"].outputs[-1]
    tout = resumed.report()["t"].outputs[-1]
    for k in ("allow", "headers", "payload"):
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k].numpy())
    assert plat.report()["t"].pkts_done == 16


def test_fault_hook_corrupts_the_same_bit_as_jax():
    class Faults:
        degrade = 0.5

        def __init__(self):
            self.rng = random.Random(7)

        def gate_inject(self, tenant, nts):
            return "corrupt"

        def serving(self):
            return True

        def check_probe(self):
            pass

    def script(api, plat, deps):
        plat.backend.faults = Faults()
        feed(api, deps["t"], 9, seed=3)
        plat.run()
        assert plat.backend.capacity()["gbps"] == 50.0

    replay(script, jax_kw={"use_fused": False})


def test_fresh_buffers_never_alias_caller_tensors(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")     # I-BATCH audit per run
    plat, deps = platform(tapi, (("t", 1.0),), params_np(), use_fused=True)
    h, p = (torch.from_numpy(np.array(x))
            for x in jvpc.make_packets(8, seed=5))
    h0, p0 = h.clone(), p.clone()
    for _ in range(2):
        deps["t"].inject(headers=h, payload=p)
        plat.run()
    outs = plat.report()["t"].outputs
    for k in ("allow", "headers", "payload"):
        assert torch.equal(outs[0][k], outs[1][k])
        assert outs[0][k].data_ptr() != outs[1][k].data_ptr()
    assert torch.equal(h, h0) and torch.equal(p, p0)
    x = torch.arange(8)
    y = _pad_to(x, 8, torch.device("cpu"))
    assert y is not x and y.data_ptr() != x.data_ptr() and torch.equal(x, y)
    assert [tapi.bucket_size(n) for n in (1, 8, 9, 100, 256, 257)] == \
        [8, 8, 16, 128, 256, 512]


# ================================================== admission diagnostics ==
def diag_keys(diags):
    return [(d.rule, d.severity, d.subject) for d in diags]


@pytest.mark.parametrize("case", ["unknown_nt", "fork_join_conflict",
                                  "over_budget", "vpc_chain"])
def test_admission_diagnostics_match_rule_for_rule(case):
    def huge(api):
        return api.ComputeNT("huge", lambda s, p: {}, writes=("x",),
                             tile_bytes=32 << 20)

    stages = {"unknown_nt": ((("firewall", "bogus"),),),
              "fork_join_conflict": ((("firewall",), ("firewall",)),),
              "over_budget": ((("huge",),),),
              "vpc_chain": ((("firewall", "nat", "chacha20"),),)}[case]
    jbe = japi.ComputeBackend(use_fused=False)
    tbe = tapi.ComputeBackend(device="cpu", use_fused=False)
    jbe.nts["huge"], tbe.nts["huge"] = huge(japi), huge(tapi)
    jd = jverifier.verify(JNTDag(1, "a", stages), backend=jbe,
                          specs=japi.VPC_SPECS)
    td = tverifier.verify(TNTDag(1, "a", stages), backend=tbe,
                          specs=tapi.VPC_SPECS)
    assert diag_keys(td) == diag_keys(jd)
    for j, t in zip(jd, td):
        if j.rule != "V-BUDGET-VMEM":           # its text names the budget
            assert t.message == j.message
    if case == "unknown_nt":
        errs = []
        for api in (japi, tapi):
            kw = {} if api is japi else {"device": "cpu"}
            plat = api.Platform(api.ComputeBackend(**kw), specs=api.VPC_SPECS)
            with pytest.raises(api.DagError) as ei:
                plat.tenant("a").deploy(api.nt("firewall") >> api.nt("bogus"))
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


# ============================================ device and ported paths ==
def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        be = tapi.ComputeBackend()
        assert be.device == torch.device("cuda", 0) and be.use_fused
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.ComputeBackend()
    be = tapi.ComputeBackend(device="cpu")
    assert be.device == torch.device("cpu") and not be.use_fused
    assert be.capacity()["device"] == "cpu"


def test_streaming_and_fleet_raise_not_implemented():
    """The streaming engine, the shard fleet and trace replay are ported:
    none of their entry points raises ``NotImplementedError`` any more."""
    be = tapi.ComputeBackend(device="cpu", stream=True)
    assert be.stream and be.max_inflight == be.ring_depth == 4
    be.run()                                    # empty backlog: a no-op
    be.run(stream=True)
    assert be.inject_stream(iter(())) == 0
    assert be.inflight_batches == 0 and be.ring.stats()["allocs"] == 0
    fleet = tapi.Platform([be, tapi.ComputeBackend(device="cpu")])
    assert isinstance(fleet.backend, tapi.ShardedBackend)
    from repro_torch.workloads import Trace
    res = tapi.Platform(tapi.ComputeBackend(device="cpu")).drive(
        Trace("empty", seed=0, epochs=1, tenants=[], events=[]))
    assert res.backend == "compute" and res.served == {}


def test_params_from_numpy_round_trip():
    src = params_np(counter0=3)
    got = params_from_numpy(src, "cpu")
    for x, y in zip(got["firewall"]["rules"], RULES):
        assert x.dtype == (torch.bool if y.dtype == np.bool_
                           else torch.uint32)
        np.testing.assert_array_equal(x.numpy(), y)
    for k, want in (("key", KEY), ("nonce", NONCE)):
        assert got["chacha20"][k].dtype == torch.uint32
        np.testing.assert_array_equal(got["chacha20"][k].numpy(), want)
    assert int(got["nat"]["nat_ip"]) == 0x0A000001
    assert got["chacha20"]["counter0"] == 3
    assert src["firewall"]["rules"] is RULES          # input left alone
