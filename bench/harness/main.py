"""One run of one cell of ``BENCHMARK.json``: the module named by the
cell's traffic file (``"kind"``) runs set-up, the window and the check;
each metric is read from the run's record by the reader of its own name,
``bench/metrics/<name>.py``, or where there is none by the reader named
by the part before the name's first dot (``device_idle.train`` falls back
to ``device_idle.py``), so one reader serves a quantity split by cell
kind.  A reader's ``read(rec)`` returns a number, or None where it finds
nothing to read, and the metric is then left out.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` the per-layer metrics that list the cell or move one of its
end-to-end metrics.

The last line of standard output is one JSON object; the numbers compared
to decide ``correct`` come last in it (``checks``) and as the last lines
of standard error.  The run fails, printing no result, without as many
CUDA devices as the cell asks for, or where a module of JAX, Flax or the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def reader(root: Path, name: str):
    """``read`` of the metric's own reader, or of the one its name's part
    before the first dot names."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv, t_start: float, root: Path, device=None) -> int:
    """``device``: None looks for the CUDA devices the cell asks for; a
    test passes ``"cpu"`` to drive the rest of a run without them."""
    args = parse(argv)
    man = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"{have} available", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    hf = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    runner = importlib.import_module(f"bench.harness.{mix['kind']}")
    ctx = SimpleNamespace(hf=hf, mix=mix, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=device, t_start=t_start, cell=cell)
    rec = runner.run(ctx)
    rec["setup_s"] = rec["t0"] - t_start
    rec["device_name"] = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    rec["power_limit"] = power_limit() if device.type == "cuda" else None
    metrics = {}
    for m in cell_metrics(man, args.workload, bool(args.trace)):
        value = reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that a run may not load: {bad}",
              file=sys.stderr)
        return 3
    print(f"run {json.dumps(rec.get('phases', {}))}", file=sys.stderr)
    chk = rec["check"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": rec["device_name"], "count": cell["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"],
           "power_limit": rec["power_limit"]}
    line = {"correct": bool(chk["correct"]),
            "attempted": int(chk["attempted"]),
            "failed": int(chk["failed"]), "metrics": metrics, "device": dev}
    if args.trace and "trace" in rec:
        from .trace import breakdown
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = breakdown(rec["trace"])
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in chk["compared"].items()}
    for k, (v, lim) in chk["compared"].items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


__all__ = ["FORBIDDEN", "cell_metrics", "forbidden_modules", "main",
           "reader"]
