#!/usr/bin/env python3
"""The dry run and the roofline of a set of cells, in parallel processes.

    python3 tools/dryrun_cells.py --shapes decode_32k long_500k \\
        [--archs A ...] [--jobs 8] [--root DIR] [--no-roofline]

For every applicable (arch x shape) of ``configs.all_cells`` among the
archs and shapes named (every arch by default), runs ``python -m
repro_torch.launch.dryrun --arch A --shape S --mesh M`` for both
production meshes, ``--jobs`` processes at a time, then ``python -m
repro_torch.roofline.analysis --arch A --shape S --mesh M --no-cache`` for
each the same way.  ``--root`` takes another checkout's ``src`` (its
records land in that checkout's ``experiments/``).  Each process's output
goes to ``experiments/dryrun_logs/``; exits 1 if any failed.  Host only:
the fake process group needs no device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")


def run(cmd: list, env: dict, log: Path) -> tuple[int, float]:
    t0 = time.time()
    with log.open("w") as f:
        rc = subprocess.call(cmd, env=env, stdout=f, stderr=subprocess.STDOUT)
    return rc, time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+", required=True)
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--no-roofline", action="store_true")
    a = ap.parse_args(argv)
    src = Path(a.root).resolve() / "src"
    sys.path.insert(0, str(src))
    from repro_torch import configs
    cells = [(arch, shape) for arch, shape, _, _ in configs.all_cells()
             if shape in a.shapes and (not a.archs or arch in a.archs)]
    env = {**os.environ, "PYTHONPATH": str(src), "OMP_NUM_THREADS": "1"}
    logs = ROOT / "experiments" / "dryrun_logs"
    logs.mkdir(parents=True, exist_ok=True)
    tag = Path(a.root).resolve().name
    stages = [("dryrun", ["-m", "repro_torch.launch.dryrun"])]
    if not a.no_roofline:
        stages.append(("roofline", ["-m", "repro_torch.roofline.analysis",
                                    "--no-cache"]))
    failed = 0
    for stage, mod in stages:
        jobs = [(arch, shape, mesh) for arch, shape in cells
                for mesh in MESHES]
        t0 = time.time()
        with ThreadPoolExecutor(a.jobs) as pool:
            done = list(pool.map(lambda c: run(
                [sys.executable, *mod, "--arch", c[0], "--shape", c[1],
                 "--mesh", c[2]], env,
                logs / f"{tag}__{stage}__{c[0]}__{c[1]}__{c[2]}.log"), jobs))
        for (arch, shape, mesh), (rc, s) in zip(jobs, done):
            print(f"[{stage}] {arch} x {shape} x {mesh}: rc {rc}, {s:.1f} s",
                  flush=True)
            failed += rc != 0
        print(f"[{stage}] {len(jobs)} runs in {time.time() - t0:.1f} s",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
