"""The port's analysis plane (``repro_torch.analysis``: the linter, the
baseline, the kernel-text and buffer tools, the CLI) held against the JAX
package's, on the CPU.

Each case of ``tests/test_analysis.py``'s ``TestLinter`` has a PyTorch
twin here: the same anti-pattern written with PyTorch's host syncs and
transfers, in the port's tree.  The port's linter must report on the twin
the rule set that the JAX linter reports on the original, except the rules
that have no counterpart (L-DONATE: PyTorch frees dead inputs by
refcount).  Fixtures with nothing framework-specific (L-NONDET, L-SYNTAX)
and the text tools' inputs run through both packages unchanged.  The
``hlo`` card functions raise here, where there is no card.
"""
from __future__ import annotations

import json
import textwrap

import pytest
from test_analysis import HLO_SAMPLE, LINT_FIXTURES, LINT_PATHS

from repro.analysis import diagnostics as jdiag
from repro.analysis import hlo as jhlo
from repro.analysis.linter import lint_source as jlint

from repro_torch.analysis import diagnostics as tdiag
from repro_torch.analysis import hlo as thlo
from repro_torch.analysis.__main__ import (DEFAULT_BASELINE,
                                           DEFAULT_LINT_PATHS,
                                           DEFAULT_MYPY_BASELINE, main)
from repro_torch.analysis.linter import RULES, lint_paths, lint_source

#: rules of the JAX linter the port has no counterpart for
NO_COUNTERPART = {"L-DONATE"}


def rules_of(diags) -> set:
    return {d.rule for d in diags}


def src(text: str) -> str:
    return textwrap.dedent(text)


# ================================================================ the linter
#: case -> (JAX source, JAX path, PyTorch twin, twin's path, the rules the
#: JAX linter reports on the original, as its test asserts)
TWINS = {
    "fixture_hostsync": (
        LINT_FIXTURES["L-HOSTSYNC"], LINT_PATHS["L-HOSTSYNC"], """
        import torch
        def f(items):
            out = []
            for x in items:
                out.append(x.item())
            return out
        """, "src/repro_torch/api/x.py", {"L-HOSTSYNC"}),
    "fixture_jitcache": (
        LINT_FIXTURES["L-JITCACHE"], LINT_PATHS["L-JITCACHE"], """
        import torch
        def f(fns, x):
            for fn in fns:
                x = torch.compile(fn)(x)
            return x
        """, "src/repro_torch/api/x.py", {"L-JITCACHE"}),
    "fixture_donate": (
        LINT_FIXTURES["L-DONATE"], LINT_PATHS["L-DONATE"], """
        import torch
        def build(step):
            return torch.compile(step)
        """, "src/repro_torch/api/some_backend.py", {"L-DONATE"}),
    "fixture_nondet": (
        LINT_FIXTURES["L-NONDET"], LINT_PATHS["L-NONDET"],
        LINT_FIXTURES["L-NONDET"], "src/repro_torch/core/x.py",
        {"L-NONDET"}),
    "fixture_ring": (
        LINT_FIXTURES["L-RING"], LINT_PATHS["L-RING"], """
        import torch
        def feed(items, device):
            for b in items:
                launch(b.to(device))
        """, "src/repro_torch/api/some_backend.py", {"L-RING"}),
    "fixture_syntax": (
        LINT_FIXTURES["L-SYNTAX"], LINT_PATHS["L-SYNTAX"],
        LINT_FIXTURES["L-SYNTAX"], "src/repro_torch/api/x.py",
        {"L-SYNTAX"}),
    "sync_module_calls_in_loop": ("""
        import jax
        import numpy as np
        def f(xs):
            return [np.asarray(x) for x in xs]
        """, "src/repro/a.py", """
        import numpy as np
        import torch
        def f(xs):
            return [np.asarray(x) for x in xs]
        """, "src/repro_torch/a.py", {"L-HOSTSYNC"}),
    "int_over_subscript_in_loop": ("""
        import jax
        def f(tok, n):
            return [int(tok[j]) for j in range(n)]
        """, "src/repro/a.py", """
        import torch
        def f(tok, n):
            return [int(tok[j]) for j in range(n)]
        """, "src/repro_torch/a.py", {"L-HOSTSYNC"}),
    "shape_subscript_not_flagged": ("""
        import jax
        def f(batch):
            return [int(v.shape[0]) for v in batch]
        """, "src/repro/a.py", """
        import torch
        def f(batch):
            return [int(v.shape[0]) for v in batch]
        """, "src/repro_torch/a.py", set()),
    "non_framework_file_int_subscript_silent": ("""
        def f(rows):
            return [int(r[0]) for r in rows]
        """, "src/repro/a.py", """
        def f(rows):
            return [int(r[0]) for r in rows]
        """, "src/repro_torch/a.py", set()),
    "noqa_suppresses": ("""
        import jax
        def f(items):
            return [x.item() for x in items]  # noqa: L-HOSTSYNC
        """, "src/repro/a.py", """
        import torch
        def f(items):
            return [x.cpu() for x in items]  # noqa: L-HOSTSYNC
        """, "src/repro_torch/a.py", set()),
    "donate_outside_dispatch_files": ("""
        import jax
        def build(step):
            return jax.jit(step)
        """, "src/repro/launch/notes.py", """
        import torch
        def build(step):
            return torch.compile(step)
        """, "src/repro_torch/launch/notes.py", set()),
    "donate_in_dispatch_files": ("""
        import jax
        def build(step):
            return jax.jit(step)
        """, "src/repro/serving/thing.py", """
        import torch
        def build(step):
            return torch.compile(step)
        """, "src/repro_torch/serving/thing.py", {"L-DONATE"}),
    "ring_slot_transfer_exempt": ("""
        import jax
        def feed(items, ring):
            for b in items:
                slot = ring.acquire(b)
                launch(jax.device_put(slot.staging, None))
        """, "src/repro/api/some_backend.py", """
        import torch
        def feed(items, ring, device):
            for b in items:
                slot = ring.acquire(b)
                launch(slot.staging.to(device, non_blocking=True))
        """, "src/repro_torch/api/some_backend.py", set()),
    "ring_scoped_to_dispatch_files": (
        LINT_FIXTURES["L-RING"], "src/repro/core/sim.py", """
        import torch
        def feed(items, device):
            for b in items:
                launch(b.to(device))
        """, "src/repro_torch/core/sim.py", set()),
    "ring_outside_loop_silent": ("""
        import jax
        def pin(state, device):
            return jax.device_put(state, device)
        """, "src/repro/api/some_backend.py", """
        import torch
        def pin(state, device):
            return state.to(device)
        """, "src/repro_torch/api/some_backend.py", set()),
    "hostsync_ring_drain_exempt": ("""
        import jax
        def drain(inflight):
            while wrapped(inflight):
                jax.block_until_ready(inflight[0].out)
        """, "src/repro/api/some_backend.py", """
        import torch
        def drain(inflight):
            while wrapped(inflight):
                inflight[0].done.synchronize()
        """, "src/repro_torch/api/some_backend.py", set()),
    "hostsync_plain_drain": ("""
        import jax
        def drain(outs):
            for o in outs:
                jax.block_until_ready(o)
        """, "src/repro/api/some_backend.py", """
        import torch
        def drain(events):
            for ev in events:
                ev.synchronize()
        """, "src/repro_torch/api/some_backend.py", {"L-HOSTSYNC"}),
    "nondet_scoped_to_core": (
        LINT_FIXTURES["L-NONDET"], "src/repro/launch/x.py",
        LINT_FIXTURES["L-NONDET"], "src/repro_torch/launch/x.py", set()),
}


@pytest.mark.parametrize("case", sorted(TWINS))
def test_twin_reports_the_jax_linters_rules(case):
    j_src, j_path, t_src, t_path, expect = TWINS[case]
    j_rules = rules_of(jlint(src(j_src), j_path))
    assert j_rules == expect
    t_diags = lint_source(src(t_src), t_path)
    assert rules_of(t_diags) == j_rules - NO_COUNTERPART, \
        tdiag.render_text(t_diags)


def test_no_counterpart_rule_is_kept_in_the_table_and_never_emitted():
    assert set(RULES) >= {"L-HOSTSYNC", "L-RING", "L-JITCACHE", "L-NONDET",
                          "L-SYNTAX", "L-DONATE"}
    for rule in NO_COUNTERPART:
        severity, what = RULES[rule]
        assert severity is None and what.startswith("no counterpart")
    for rule, (severity, _) in RULES.items():
        if rule not in NO_COUNTERPART:
            assert severity in (tdiag.Severity.ERROR,
                                tdiag.Severity.WARNING)


#: PyTorch's own syncs, transfers, compiles and global draws: (source,
#: path, rules)
TORCH_CASES = {
    "tolist_in_loop": ("""
        import torch
        def f(xs):
            return [x.tolist() for x in xs]
        """, "src/repro_torch/a.py", {"L-HOSTSYNC"}),
    "numpy_in_loop": ("""
        import torch
        def f(xs):
            for x in xs:
                yield x.numpy()
        """, "src/repro_torch/a.py", {"L-HOSTSYNC"}),
    "cuda_synchronize_in_loop": ("""
        import torch
        def f(xs):
            for x in xs:
                launch(x)
                torch.cuda.synchronize()
        """, "src/repro_torch/a.py", {"L-HOSTSYNC"}),
    "cuda_synchronize_after_loop": ("""
        import torch
        def f(xs):
            for x in xs:
                launch(x)
            torch.cuda.synchronize()
        """, "src/repro_torch/a.py", set()),
    "float_subscript_outside_torch_file": ("""
        def f(rows):
            return [float(r[0]) for r in rows]
        """, "src/repro_torch/a.py", set()),
    "cuda_call_in_dispatch_loop": ("""
        import torch
        def feed(items):
            for b in items:
                launch(b.cuda())
        """, "src/repro_torch/serving/x.py", {"L-RING"}),
    "as_tensor_with_device_in_dispatch_loop": ("""
        import torch
        def feed(items, dev):
            for b in items:
                launch(torch.as_tensor(b, device=dev))
        """, "src/repro_torch/kernels/x.py", {"L-RING"}),
    "as_tensor_on_the_host_in_dispatch_loop": ("""
        import torch
        def feed(items):
            for b in items:
                launch(torch.as_tensor(b))
        """, "src/repro_torch/kernels/x.py", set()),
    "dtype_cast_in_dispatch_loop": ("""
        import torch
        def feed(items):
            for b in items:
                launch(b.to(torch.float32))
        """, "src/repro_torch/api/x_backend.py", set()),
    "cuda_graph_in_loop": ("""
        import torch
        def f(steps):
            for s in steps:
                g = torch.cuda.CUDAGraph()
        """, "src/repro_torch/a.py", {"L-JITCACHE"}),
    "kernel_build_in_loop": ("""
        from repro_torch.kernels import _build
        def f(names):
            return [_build.library(n) for n in names]
        """, "src/repro_torch/a.py", {"L-JITCACHE"}),
    "unseeded_torch_draw_in_core": ("""
        import torch
        def jitter(n):
            return torch.rand(n)
        """, "src/repro_torch/core/x.py", {"L-NONDET"}),
    "seeded_torch_draw_in_core": ("""
        import torch
        def jitter(n, gen):
            return torch.randn(n, generator=gen)
        """, "src/repro_torch/workloads/x.py", set()),
    "manual_seed_in_workloads": ("""
        import torch
        def setup():
            torch.manual_seed(0)
        """, "src/repro_torch/workloads/x.py", {"L-NONDET"}),
    "manual_seed_outside_core": ("""
        import torch
        def setup():
            torch.manual_seed(0)
        """, "src/repro_torch/launch/x.py", set()),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_specific_rules(case):
    text, path, expect = TORCH_CASES[case]
    diags = lint_source(src(text), path)
    assert rules_of(diags) == expect, tdiag.render_text(diags)


def test_port_tree_is_lint_clean_against_its_baseline():
    diags = lint_paths(["src/repro_torch"])
    fresh = tdiag.Baseline.load("analysis_baseline_torch.json").new(diags)
    assert fresh == [], tdiag.render_text(fresh)


# =========================================================== baseline gating
def _baseline_cases(pkg):
    """``tests/test_analysis.py``'s ``TestBaseline`` on one package's
    diagnostics module; returns what each case observed."""
    def d(rule, subject):
        return pkg.Diagnostic(rule, pkg.Severity.ERROR, subject, "msg")
    old = [d("L-X", "a.py:10"), d("L-X", "a.py:20")]
    base = pkg.Baseline.from_diags(old)
    one = pkg.Baseline.from_diags([d("L-X", "a.py:10")])
    mixed = [pkg.Diagnostic("B", pkg.Severity.WARNING, "b", "warn"),
             pkg.Diagnostic("A", pkg.Severity.ERROR, "a", "err")]
    return {
        "grandfathered": [str(x) for x in base.new(old)],
        "one_more": [str(x) for x in base.new(old + [d("L-X", "a.py:30")])],
        "line_moved": [str(x) for x in one.new([d("L-X", "a.py:999")])],
        "new_rule": [str(x) for x in one.new([d("L-Y", "a.py:10")])],
        "counts": base.counts,
        "sorted_first": pkg.sort_diags(mixed)[0].rule,
        "text": pkg.render_text(mixed),
        "json": json.loads(pkg.to_json(mixed)),
    }


def test_baseline_behaves_as_jax():
    got, want = _baseline_cases(tdiag), _baseline_cases(jdiag)
    assert got == want
    assert got["one_more"] and not got["grandfathered"]
    assert "1 error(s), 1 warning(s)" in got["text"]


def test_baseline_roundtrip_reads_the_jax_file_format(tmp_path):
    d = tdiag.Diagnostic("L-X", tdiag.Severity.ERROR, "a.py:10", "msg")
    tdiag.Baseline.from_diags([d]).save(tmp_path / "t.json")
    jdiag.Baseline.from_diags([jdiag.Diagnostic(
        "L-X", jdiag.Severity.ERROR, "a.py:10", "msg")]).save(
        tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert tdiag.Baseline.load(tmp_path / "j.json").counts == {"L-X::a.py": 1}
    assert tdiag.Baseline.load(tmp_path / "missing.json").counts == {}


# ============================================ kernel-text and buffer tools
@pytest.mark.parametrize("pattern,limit", [("f32", 2), ("all-reduce", 20),
                                           ("nothing-matches", 20)])
def test_grep_lines_as_jax(pattern, limit):
    got = thlo.grep_lines(HLO_SAMPLE, pattern, limit)
    assert got == jhlo.grep_lines(HLO_SAMPLE, pattern, limit)
    assert len(got) <= limit


@pytest.mark.parametrize("min_bytes", [1e6, 1e13])
def test_top_buffers_and_format_as_jax(min_bytes):
    got = thlo.top_buffers(HLO_SAMPLE, min_bytes=min_bytes)
    assert got == jhlo.top_buffers(HLO_SAMPLE, min_bytes=min_bytes)
    assert thlo.format_buffers(got) == jhlo.format_buffers(got)


def _ev(action, addr, size, filename="x.py", line=1, name="f"):
    return {"action": action, "addr": addr, "size": size,
            "frames": [{"filename": filename, "line": line, "name": name}]}


def test_peak_buffers_ranks_what_is_live_at_the_peak():
    """Blocks live at the trace's peak, aggregated per (site, size) in
    ``top_buffers``' format; a block freed before the peak is not among
    them, nor one allocated after it."""
    site = "/ck/src/repro_torch/models/attention.py"
    events = [
        _ev("alloc", 1, 400, site, 10, "scores"),
        _ev("alloc", 2, 400, site, 10, "scores"),
        _ev("alloc", 3, 300, "/torch/nn/functional.py", 5, "linear"),
        _ev("free_requested", 3, 300),
        _ev("free_completed", 3, 300),
        _ev("alloc", 4, 500, site, 20, "probs"),     # the peak: 1,300
        _ev("free_completed", 1, 400),
        _ev("alloc", 5, 350, site, 30, "later"),     # 1,250: lower
        _ev("alloc", 6, 10, site, 40, "tiny"),
        _ev("free_completed", 99, 7),                # allocated before
    ]
    bufs, peak = thlo.peak_buffers({"device_traces": [events]}, min_bytes=50)
    assert peak == 1300
    assert bufs == [("models/attention.py:10 scores [400 B]", 800),
                    ("models/attention.py:20 probs [500 B]", 500)]
    text = thlo.format_buffers(bufs)
    assert "GB" in text and "probs" in text


def test_buffers_raise_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["hlo", "buffers", "stablelm-12b", "train_4k", "--layers", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        thlo.step_snapshot("qwen3-8b", "prefill_32k", 1)


def test_grep_raises_without_the_library_or_cuobjdump(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(ValueError, match="unknown kernel"):
        thlo.sass_text("nope")
    with pytest.raises(FileNotFoundError, match="not built"):
        main(["hlo", "grep", "flash_attention", "HMMA"])
    lib = thlo.library_path("flash_attention")
    assert lib.parent == tmp_path / "kernels"
    lib.parent.mkdir()
    lib.write_bytes(b"")
    monkeypatch.setattr(thlo.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="cuobjdump"):
        thlo.sass_text("flash_attention")


# ================================================================== CLI gate
def test_cli_defaults_are_the_ports():
    assert DEFAULT_LINT_PATHS == ["src/repro_torch"]
    assert DEFAULT_BASELINE == "analysis_baseline_torch.json"
    assert DEFAULT_MYPY_BASELINE == "mypy_baseline_torch.txt"
    assert main(["lint"]) == 0


def test_lint_cli_baseline_gate(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(src(TWINS["fixture_hostsync"][2]))
    base = tmp_path / "base.json"
    # no baseline: the seeded violation fails the gate
    assert main(["lint", str(bad), "--baseline", str(base)]) == 1
    # enumerate it; the same tree now passes
    assert main(["lint", str(bad), "--baseline", str(base),
                 "--update-baseline"]) == 0
    assert main(["lint", str(bad), "--baseline", str(base)]) == 0


def test_lint_cli_json_artifact(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(src(TWINS["fixture_jitcache"][2]))
    out = tmp_path / "diags.json"
    main(["lint", str(bad), "--baseline", str(tmp_path / "none.json"),
          "--json", str(out)])
    data = json.loads(out.read_text())
    assert data and data[0]["rule"] == "L-JITCACHE"


def test_typecheck_skips_without_mypy(monkeypatch):
    import shutil as _sh
    monkeypatch.setattr(_sh, "which", lambda _: None)
    assert main(["typecheck"]) == 0
