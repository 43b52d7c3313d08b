"""The port's disaggregated KV store case study held against the JAX
package's (``serving/kv_store.py``: the paper's Clio / sNIC experiments,
figures 8-10).

The store is host Python on the event simulator: keys, the FIFO cache and
replication are real, time is simulated.  The same run on the same seed
must give an *equal* ``KVResult`` (every latency, hit and miss); the
reference's assertions from ``tests/test_serving.py::TestKVStore`` hold on
the port as well.
"""
from __future__ import annotations

import pytest

from test_torch_sim import PORT, REF, plain, same

SYSTEMS = ("clio", "clio-snic", "clio-snic-cache", "clio-snic-repl")


def ycsb(m, system, **kw):
    return m.kv.run_ycsb(system, **kw)


def cache_improves_latency_and_tput(m):
    base = ycsb(m, "clio-snic", workload="C", n_ops=8000, n_keys=20000)
    cache = ycsb(m, "clio-snic-cache", workload="C", n_ops=8000,
                 n_keys=20000, cache_entries=2048)
    assert cache.avg_us < base.avg_us and cache.hits > 0
    assert cache.kops(cache.done_ns) > base.kops(base.done_ns)
    return [base, cache, base.avg_us, cache.p99_us(),
            cache.kops(cache.done_ns)]


def snic_transport_offload_overhead_small(m):
    clio = ycsb(m, "clio", workload="C", n_ops=6000)
    snic = ycsb(m, "clio-snic", workload="C", n_ops=6000)
    assert snic.avg_us < clio.avg_us * 1.35
    return [clio, snic]


def replication_nt_cheaper_than_client_side(m):
    client = ycsb(m, "clio", workload="A", n_ops=6000, replication=2)
    snic = ycsb(m, "clio-snic-repl", workload="A", n_ops=6000,
                replication=2)
    assert snic.avg_us < client.avg_us
    return [client, snic]


def zipf_is_skewed(m):
    ks = m.kv.zipf_keys(1000, 5000, seed=1)
    assert sum(1 for k in ks if k < 10) > 1000
    return ks


@pytest.mark.parametrize("scenario", [
    cache_improves_latency_and_tput, snic_transport_offload_overhead_small,
    replication_nt_cheaper_than_client_side, zipf_is_skewed],
    ids=lambda f: f.__name__)
def test_kv_store_case_matches_jax(scenario):
    """One case of ``TestKVStore`` on both packages, results equal."""
    same(scenario)


@pytest.mark.parametrize("workload", ["A", "B", "C"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_every_system_and_workload_matches_jax(system, workload):
    """Each of the four systems under YCSB A, B and C (small runs, a seed
    and shape apart from the reference's cases): equal results."""
    same(ycsb, system, workload=workload, n_ops=1500, n_keys=3000,
         cache_entries=256, replication=2, n_clients=8, seed=5)


def test_zipf_keys_and_link_match_jax():
    """``zipf_keys`` over thetas and seeds, and a ``Link``'s serialization
    sequence, equal in both packages."""
    for theta in (0.5, 0.99, 1.2):
        for seed in (0, 3):
            assert REF.kv.zipf_keys(500, 2000, theta=theta, seed=seed) == \
                PORT.kv.zipf_keys(500, 2000, theta=theta, seed=seed)
    links = [m.kv.Link(10.0, prop_ns=50.0) for m in (REF, PORT)]
    times = [[lk.xfer(t, n) for t, n in ((0.0, 1500), (10.0, 64),
                                         (5000.0, 9000))] for lk in links]
    assert times[0] == times[1]
    assert plain(links[0]) == plain(links[1])
