"""The harness end to end at tiny sizes on the CPU: a training cell's run
prints its result line, with and without the trace."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench.tests import tiny

SEED = 2 ** 31 + 17


def argv(cell: str, trace: int) -> list[str]:
    return ["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
            "--trace", str(trace)]


def manifest() -> dict:
    return json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tmp_path, trace):
    root = tiny.make_root(tmp_path)
    cell = tiny.train_cell()
    rc, out, err = tiny.run(root, argv(cell, trace))
    assert rc == 0, err[-3000:]
    line = tiny.last_line(out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["count"] == 1
    man = manifest()
    e2e = {m["name"] for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])}
    if trace:
        allowed = {m["name"] for m in man["per_layer"]
                   if cell in m.get("workloads", [])}
        assert set(line["metrics"]) <= allowed
    else:
        assert set(line["metrics"]) == e2e
        assert line["metrics"]["setup_s"]["value"] > 0
    units = {m["name"]: m["unit"] for m in man["end_to_end"] +
             man["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] == m["value"]
    # the numbers compared close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for text, (name, c) in zip(tail, line["checks"].items()):
        assert text.startswith(name) and "limit" in text
        assert c["value"] <= c["limit"]


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bench.harness.main import main
    rc = main(argv(tiny.train_cell(), 0), 0.0, tiny.ROOT)
    assert rc != 0


def test_bench_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's own files
    gives no result."""
    shutil.copytree(tiny.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "bench/run.py", *argv(
        tiny.train_cell(), 0)], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert not p.stdout.strip()
