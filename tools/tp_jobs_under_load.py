"""Time the gloo jobs and the one-process references of
``tests/test_torch_tp.py`` on an idle host and beside a CPU load like a
busy pytest-xdist run's: ``--load`` processes, each looping PyTorch ops on
small tensors on ``--threads`` threads.

    PYTHONPATH=src python tools/tp_jobs_under_load.py --load 6
    PYTHONPATH=src python tools/tp_jobs_under_load.py --load 6 \
        --root build/parent        # another checkout's test file, same load

Prints one JSON object: each job's seconds (the three jobs one after
another where the test file runs them so, or together), every reference's
seconds by kind, and the threads the references ran on.  The jobs' own
timeouts apply: a job past its timeout is reported, not raised.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

LOAD = r'''
import sys, torch
torch.set_num_threads(int(sys.argv[1]))
a, b = torch.randn(256, 256), torch.randn(256, 512)
while True:
    torch.softmax(a @ b, -1).sum(0)
'''


def load_module(root: Path):
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "tp_under_load", root / "tests" / "test_torch_tp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_jobs(T, tmp: Path) -> dict:
    out = {}
    t0 = time.perf_counter()
    try:
        if hasattr(T, "run_jobs"):                 # the jobs at once
            T.run_jobs(tmp)
        else:                                      # one after another
            for job, world, limit in (("four", 4, 400), ("eight", 8, 300),
                                      ("two", 2, 200)):
                t1 = time.perf_counter()
                T.run_job(tmp, job, world, limit)
                out[job] = time.perf_counter() - t1
    except (AssertionError, subprocess.TimeoutExpired) as e:
        out["failed"] = f"{type(e).__name__}: {str(e)[-300:]}"
    out["all"] = time.perf_counter() - t0
    return out


def time_references(T) -> dict:
    import torch

    def timed(fn, *a, **k):
        t0 = time.perf_counter()
        fn(*a, **k)
        return time.perf_counter() - t0
    out = {"steps": sum(timed(T.one_process, arch, batch, c)
                        for arch, batch in T.CASES for c in T.COMPRESS)}
    out["prefills"] = sum(timed(T.one_process_prefill, a) for a in T.ARCHS)
    out["decodes"] = sum(timed(T.one_process_decode, arch, B, rep)
                         for _, arch, B, rep in T.DECODE_CASES)
    tr = T.train.Trainer(T.configs.get_tiny_config("qwen2.5-32b"), seed=0,
                         device="cpu")
    run = (lambda: tr.run(T.CLI_STEPS, 16, T.SEQ, seed=0,
                          log=lambda *a: None))
    if hasattr(T, "one_thread"):
        with T.one_thread():
            out["cli"] = timed(run)
    else:
        out["cli"] = timed(run)
    out["worker_threads"] = torch.get_num_threads()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="the checkout whose tests/test_torch_tp.py to time")
    ap.add_argument("--load", type=int, default=0,
                    help="processes of PyTorch load beside it")
    ap.add_argument("--threads", type=int, default=8,
                    help="threads of each load process")
    args = ap.parse_args(argv)
    T = load_module(args.root.resolve())
    load = [subprocess.Popen([sys.executable, "-c", LOAD,
                              str(args.threads)])
            for _ in range(args.load)]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            got = {"root": str(args.root), "load": args.load,
                   "threads": args.threads,
                   "jobs_s": time_jobs(T, Path(tmp)),
                   "references_s": time_references(T)}
    finally:
        for p in load:
            p.kill()
            p.wait()
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
