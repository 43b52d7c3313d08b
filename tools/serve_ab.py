#!/usr/bin/env python3
"""Serving before and after on one card: serve phases of ``chip_smoke.py``
from two checkouts, run in turns.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/serve_ab.py --old build/parent

Runs ``chip_smoke.serve_path`` for each of ``--phases`` (by default
``serve_rwkv`` and ``serve_hybrid``, the paths of the two scan kernels)
from the old checkout and from this one, each run in a process of its own
that builds that checkout's kernels into that checkout's ``build/``, in
the order old, new, new, old.  Each run passes that checkout's own checks
of the phase.  Prints the ``nvidia-smi`` name and power limit, then per run
and phase the generated tokens/s, mean and max time to first token, the
served run's wall seconds, its prefill groups and, where that checkout
records them, each kernel's device ms a run (``*_ms_per_run``); writes
them all to ``chiprun_out/serve_ab.json``.  A phase of
``chip_smoke.TRAIN_FAMILIES`` (``--phases train_hybrid``) runs
``family_train_path`` instead, gates included, and keeps its step seconds,
median step and tokens/s.  Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("serve_rwkv", "serve_hybrid")
#: the phase record's keys kept, beside every ``*_ms_per_run``
KEYS = ("phase", "arch", "layers", "reduced", "tokens_per_s", "mean_ttft_s",
        "max_ttft_s", "seconds", "prefill_groups", "decode_steps",
        "launches", "max_memory_gb", "step_seconds", "median_step_s_2_to_5")


def child(root: Path, phases: list) -> int:
    """Run the serve (or family train) phases of the checkout at
    ``root``; one JSON line each."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.Card()
    for phase in phases:
        if phase in cs.TRAIN_FAMILIES:
            record, _, _ = cs.family_train_path(dev, card, phase)
            print(json.dumps({k: v for k, v in record.items()
                              if k in KEYS}), flush=True)
            del record
            cs.free_device()
            continue
        arch, n_layers, requests = cs.SERVE_PHASES[phase]
        cfg = get_config(arch)
        reduced = {}
        if n_layers is not None:
            reduced["n_layers"] = f"{cfg.n_layers} -> {n_layers}"
            cfg = cfg.replace(n_layers=n_layers)
        record, _ = cs.serve_path(dev, card, phase, cfg, requests, reduced)
        print(json.dumps({k: v for k, v in record.items()
                          if k in KEYS or k.endswith("_ms_per_run")}),
              flush=True)
        del record
        cs.free_device()
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, required=True,
                   help="root of the earlier checkout")
    p.add_argument("--phases", nargs="+", default=list(PHASES))
    p.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.child is not None:
        return child(a.child.resolve(), a.phases)
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    smi = cs.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    roots = {"old": a.old.resolve(), "new": ROOT}
    runs = []
    for version in ("old", "new", "new", "old"):
        proc = subprocess.run(
            [sys.executable, __file__, "--old", str(a.old), "--child",
             str(roots[version]), "--phases", *a.phases],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {version} run failed "
                               f"(exit {proc.returncode})")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = {"version": version, **json.loads(line)}
                runs.append(rec)
                print(json.dumps(rec), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_ab.json").write_text(json.dumps(
        {"card": smi, "old": str(a.old), "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
