"""The port's perfbench (``repro_torch.perfbench``) held against the JAX
package's (``repro.perfbench``), on the CPU.

Every case of ``tests/test_perfbench.py`` runs on both packages (one
parametrised test per behaviour).  Where a case compares two snapshots,
the verdict dict (``CompareResult.to_dict()``) and the text report
(``format_report``) of the port equal the JAX package's, so one snapshot
pair gates the same way in both.  The port's bench registry is empty, so
its ``run`` and ``bisect`` exit 2 on any name.
"""
from __future__ import annotations

import copy
import importlib
import json

import pytest

PKGS = ("repro", "repro_torch")
SNAP = {
    "bench": "toy", "mode": "smoke",
    "sweep": [{"batch": 64, "pkts_per_s": 1000.0, "gbps": 0.5},
              {"batch": 256, "pkts_per_s": 4000.0, "gbps": 2.0}],
    "latency": {"p99_us": 120.0},
    "drops": 0,
    "_seconds": 3.2,
    "fingerprint": "abcd",
}


def pb(pkg: str, module: str = ""):
    return importlib.import_module(f"{pkg}.perfbench{module}")


def slowed(snap: dict, rows=(0, 1)) -> dict:
    out = copy.deepcopy(snap)
    for i in rows:
        out["sweep"][i]["pkts_per_s"] /= 2.0
    return out


def noisy(values) -> dict:
    return {"repeats": [{"pkts_per_s": v} for v in values]}


def without_latency_with_extra() -> dict:
    cand = copy.deepcopy(SNAP)
    del cand["latency"]
    cand["extra"] = {"pkts_per_s": 5.0}
    return cand


def with_p99(us: float) -> dict:
    cand = copy.deepcopy(SNAP)
    cand["latency"]["p99_us"] = us
    return cand


# ================================================================= metrics ==
@pytest.mark.parametrize("pkg", PKGS)
def test_flatten_paths_and_underscore_skip(pkg):
    flat = pb(pkg).flatten(SNAP)
    assert flat["sweep.0.pkts_per_s"] == [1000.0]
    assert flat["latency.p99_us"] == [120.0]
    assert "_seconds" not in flat
    assert "bench" not in flat          # strings are not metrics


@pytest.mark.parametrize("pkg", PKGS)
def test_list_leaves_become_repeat_samples(pkg):
    flat = pb(pkg).flatten({"x": {"pkts_per_s": [10.0, 12.0, 11.0]}})
    assert flat["x.pkts_per_s"] == [10.0, 12.0, 11.0]


@pytest.mark.parametrize("pkg", PKGS)
def test_repeats_envelope_pools_per_metric(pkg):
    env = {"bench": "toy",
           "repeats": [{"pkts_per_s": 10.0}, {"pkts_per_s": 12.0}]}
    stats = pb(pkg).metric_stats([env])
    assert stats["pkts_per_s"].n == 2
    assert stats["pkts_per_s"].mean == pytest.approx(11.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_stat_cv(pkg):
    Stat = pb(pkg).Stat
    s = Stat.of([10.0, 12.0, 11.0])
    assert s.cv == pytest.approx(0.0909, abs=1e-3)
    assert Stat.of([5.0]).cv == 0.0


def test_flattened_snapshots_and_stats_equal_jax():
    snaps = [SNAP, noisy((900.0, 1000.0, 1100.0)),
             {"x": {"pkts_per_s": [10.0, 12.0, 11.0]}, "ok": True,
              "nan": float("nan")}]
    for snap in snaps:
        assert pb("repro_torch").flatten(snap) == pb("repro").flatten(snap)
    mine = pb("repro_torch").metric_stats(snaps)
    ref = pb("repro").metric_stats(snaps)
    assert {p: vars(s) for p, s in mine.items()} == \
        {p: vars(s) for p, s in ref.items()}


# =============================================================== direction ==
@pytest.mark.parametrize("pkg", PKGS)
def test_direction_classification(pkg):
    direction = pb(pkg).direction
    assert direction("sweep.0.pkts_per_s") == "higher"
    assert direction("latency.p99_us") == "lower"
    assert direction("run.recovery_epochs") == "lower"
    assert direction("cache.distinct_buckets") == "info"


@pytest.mark.parametrize("pkg", PKGS)
def test_direction_longest_fragment_wins(pkg):
    # 'drops_ratio' must gate as a drop count (lower), not a ratio
    assert pb(pkg).direction("tenant.drops") == "lower"


def test_direction_equals_jax_on_every_fragment():
    jc = pb("repro", ".compare")
    frags = jc._HIGHER + jc._LOWER
    assert pb("repro_torch", ".compare")._HIGHER == jc._HIGHER
    assert pb("repro_torch", ".compare")._LOWER == jc._LOWER
    paths = [f"a.{f}" for f in frags] + [
        f"a.{f}_{g}" for f in frags for g in frags] + ["x.y", "tenant.drops"]
    assert [pb("repro_torch").direction(p) for p in paths] == \
        [pb("repro").direction(p) for p in paths]


# ================================================================= compare ==
#: (case, baseline snapshots, candidate snapshots, compare keywords, passed,
#: regressed paths, improved paths)
COMPARE_CASES = {
    "identical_snapshots_pass": (
        [SNAP], [copy.deepcopy(SNAP)], {}, True, [], []),
    "synthetic_2x_slowdown_fails": (
        [SNAP], [slowed(SNAP)], {}, False,
        ["sweep.0.pkts_per_s", "sweep.1.pkts_per_s"], []),
    "latency_rise_fails": (
        [SNAP], [with_p99(200.0)], {}, False, ["latency.p99_us"], []),
    "latency_drop_improves": (
        [SNAP], [with_p99(60.0)], {}, True, [], ["latency.p99_us"]),
    # a 20 % delta on a metric whose repeats carry 10 % CV passes at k = 3
    # (gate 30 %) and fails with the variance gate off
    "variance_gate_absorbs_noise": (
        [noisy((900.0, 1000.0, 1100.0))], [noisy((700.0, 800.0, 900.0))],
        {"threshold": 0.10, "k": 3.0}, True, [], []),
    "variance_gate_off_fails": (
        [noisy((900.0, 1000.0, 1100.0))], [noisy((700.0, 800.0, 900.0))],
        {"threshold": 0.10, "k": 0.0}, False, ["pkts_per_s"], []),
    "skip_filter": (
        [SNAP], [slowed(SNAP)], {"skip": ["sweep"]}, True, [], []),
    "only_filter_elsewhere": (
        [SNAP], [slowed(SNAP)], {"only": ["latency*"]}, True, [], []),
    "only_filter_on_it": (
        [SNAP], [slowed(SNAP)], {"only": ["sweep*"]}, False,
        ["sweep.0.pkts_per_s", "sweep.1.pkts_per_s"], []),
    "missing_and_new_metrics_reported_not_gating": (
        [SNAP], [without_latency_with_extra()], {}, True, [], []),
    "one_row_slowed": (
        [SNAP], [slowed(SNAP, rows=(0,))], {}, False,
        ["sweep.0.pkts_per_s"], []),
    "pooled_candidates": (
        [SNAP], [SNAP, slowed(SNAP)], {"k": 1.0}, True, [], []),
}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", COMPARE_CASES)
def test_compare_verdicts(case, pkg):
    base, cand, kw, passed, regressed, improved = COMPARE_CASES[case]
    res = pb(pkg).compare(base, cand, **kw)
    assert res.passed == passed
    assert sorted(d.path for d in res.regressions) == regressed
    assert sorted(d.path for d in res.improvements) == improved
    if case == "missing_and_new_metrics_reported_not_gating":
        assert res.only_base == ["latency.p99_us"]
        assert res.only_cand == ["extra.pkts_per_s"]


@pytest.mark.parametrize("case", COMPARE_CASES)
def test_compare_verdict_and_report_equal_jax(case):
    """One snapshot pair, both packages: the same verdict dict and the
    same report, verbose or not."""
    base, cand, kw, *_ = COMPARE_CASES[case]
    mine = pb("repro_torch").compare(base, cand, **kw)
    ref = pb("repro").compare(base, cand, **kw)
    assert mine.to_dict() == ref.to_dict()
    for verbose in (False, True):
        assert pb("repro_torch").format_report(mine, verbose=verbose) == \
            pb("repro").format_report(ref, verbose=verbose)


@pytest.mark.parametrize("pkg", PKGS)
def test_format_report_names_verdict(pkg):
    text = pb(pkg).format_report(pb(pkg).compare([SNAP],
                                                 [slowed(SNAP, (0,))]))
    assert "REGRESSED" in text and "FAIL" in text


# ============================================================== trajectory ==
@pytest.mark.parametrize("pkg", PKGS)
def test_trajectory_append_and_bound(pkg, tmp_path):
    ledger = tmp_path / "BENCH_trajectory.json"
    for i in range(5):
        pb(pkg, ".trajectory").append_entry(ledger, bench="toy",
                                            snapshot=SNAP, commit=f"c{i}",
                                            keep=3)
    data = pb(pkg).load_trajectory(ledger)
    assert [e["commit"] for e in data["entries"]] == ["c2", "c3", "c4"]
    assert data["entries"][-1]["metrics"]["latency.p99_us"] == 120.0


@pytest.mark.parametrize("pkg", PKGS)
def test_trajectory_verdict_recorded(pkg, tmp_path):
    ledger = tmp_path / "t.json"
    res = pb(pkg).compare([SNAP], [copy.deepcopy(SNAP)])
    entry = pb(pkg, ".trajectory").append_entry(
        ledger, bench="toy", snapshot=SNAP, verdict=res.to_dict(),
        commit="x")
    assert entry["verdict"]["pass"] is True


def test_trajectory_files_equal_jax(tmp_path):
    """The same entries written by both packages make the same file."""
    for pkg in PKGS:
        res = pb(pkg).compare([SNAP], [slowed(SNAP)])
        for i in range(4):
            pb(pkg, ".trajectory").append_entry(
                tmp_path / f"{pkg}.json", bench="toy", snapshot=SNAP,
                verdict=res.to_dict(), commit=f"c{i}", label="l", keep=3)
    assert (tmp_path / "repro_torch.json").read_text() == \
        (tmp_path / "repro.json").read_text()


# ================================================================== bisect ==
COMMITS = [f"c{i}" for i in range(10)]


@pytest.mark.parametrize("pkg", PKGS)
def test_bisect_finds_first_bad(pkg):
    for first_bad in range(1, 10):
        probe = lambda c: int(c[1:]) < first_bad  # noqa: E731
        found, probes = pb(pkg).bisect_first_bad(COMMITS, probe)
        assert found == f"c{first_bad}"
        assert probes <= 4              # log2(10) rounds


@pytest.mark.parametrize("pkg", PKGS)
def test_bisect_endpoint_verification(pkg):
    bisect_first_bad = pb(pkg).bisect_first_bad
    with pytest.raises(ValueError, match="already bad"):
        bisect_first_bad(COMMITS, lambda c: False, assume_endpoints=False)
    with pytest.raises(ValueError, match="still good"):
        bisect_first_bad(COMMITS, lambda c: True, assume_endpoints=False)


@pytest.mark.parametrize("pkg", PKGS)
def test_bisect_probe_gates_with_compare(pkg, tmp_path):
    """make_bench_probe with an injected runner: commits at/after the
    regression return a slowed snapshot and must probe bad."""
    baseline = tmp_path / "base.json"
    baseline.write_text(json.dumps(SNAP))

    def runner(commit, workdir):
        return slowed(SNAP) if int(commit[1:]) >= 6 else copy.deepcopy(SNAP)

    logs = []
    probe = pb(pkg, ".bisect").make_bench_probe("toy", baseline,
                                                runner=runner,
                                                log=logs.append)
    found, _ = pb(pkg).bisect_first_bad(COMMITS, probe)
    assert found == "c6"
    assert any("BAD" in line for line in logs)


# ===================================================================== CLI ==
@pytest.mark.parametrize("pkg", PKGS)
def test_cli_compare_exit_codes(pkg, tmp_path, capsys):
    main = pb(pkg, ".__main__").main
    base = tmp_path / "base.json"
    base.write_text(json.dumps(SNAP))
    same = tmp_path / "same.json"
    same.write_text(json.dumps(SNAP))
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps(slowed(SNAP)))
    ledger = tmp_path / "traj.json"

    assert main(["compare", str(base), str(same),
                 "--trajectory", str(ledger), "--bench", "toy"]) == 0
    assert main(["compare", str(base), str(slow)]) == 1
    assert main(["compare", str(base), str(tmp_path / "nope.json")]) == 2
    assert len(pb(pkg).load_trajectory(ledger)["entries"]) == 1


def test_cli_compare_prints_what_jax_prints(tmp_path, capsys):
    base = tmp_path / "base.json"
    base.write_text(json.dumps(SNAP))
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps(slowed(SNAP, (1,))))
    outs = []
    for pkg in PKGS:
        rc = pb(pkg, ".__main__").main(["compare", str(base), str(slow),
                                        "--verbose", "--json"])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0][0] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_cli_run_rejects_unknown_bench(pkg):
    assert pb(pkg, ".__main__").main(["run", "no_such_bench"]) == 2


@pytest.mark.parametrize("name", ["bench_compute", "bench_scenarios",
                                  "no_such_bench"])
def test_port_registry_is_empty_so_run_and_bisect_exit_2(name, tmp_path,
                                                         capsys):
    """The port's registry waits for the port's benches: every name,
    the JAX package's too, is refused by ``run`` and ``bisect`` (exit 2)
    with a message naming the registry, before any commit is checked
    out."""
    mod = pb("repro_torch", ".__main__")
    assert mod.SNAPSHOT_RUNNERS == {}
    base = tmp_path / "base.json"
    base.write_text(json.dumps(SNAP))
    assert mod.main(["run", name, "--out", str(tmp_path / "o.json")]) == 2
    assert mod.main(["bisect", "HEAD~1..HEAD", "--bench", name,
                     "--baseline", str(base), "--repo", str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert err.count("SNAPSHOT_RUNNERS") == 2 and name in err
    assert not (tmp_path / "o.json").exists()
    with pytest.raises(KeyError, match="unknown bench"):
        mod.run_bench(name)


def test_port_parser_names_the_port():
    assert pb("repro_torch", ".__main__").build_parser().prog == \
        "python -m repro_torch.perfbench"
