"""The readings the correctness limits are set from, on the chip.

For each seed it runs a training cell's program as a benchmark run does
(set-up, a short window, the check against the plain reference) and reads
the numbers compared.  With ``--controls`` it also reads, against the
same reference: the control, the program with its bfloat16 master-weight
path switched on (one step below the configuration's float32), and the
reference with half of each batch left out and the mean taken over the
rest.

    python3 bench/calibrate.py --workload granite.train \
        --seeds 11,12,13 --seconds 8 --controls

One JSON line a seed on standard output, and the same lines in
``--out``.  It runs the program on the card only; the benchmark's own
runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def leaves(x: dict, ref: dict) -> dict:
    """Where a run departs from the reference: each step's relative loss
    gap, and for the first gradient and the change the median leaf's gap
    and the six widest leaves (name, gap, reference norm, run's norm),
    each leaf's gap against the larger of its reference norm and the
    median leaf's."""
    out = {"loss_steps": [abs(p - r) / abs(r)
                          for p, r in zip(x["loss"], ref["loss"])]}
    for key in ("grad", "change"):
        names = sorted(ref[key])
        med = sorted(ref[key][n] for n in names)[len(names) // 2]
        g = {n: abs(x[key][n] - ref[key][n]) / max(ref[key][n], med)
             for n in names}
        order = sorted(g, key=g.get, reverse=True)
        out[key] = {"median": sorted(g.values())[len(g) // 2],
                    "worst": [[n, g[n], ref[key][n], x[key][n]]
                              for n in order[:6]]}
    return out


def bf16_program(ctx) -> dict:
    """The program's first steps with its parameters in bfloat16: the
    configuration's weights rounded, the steps as a run drives them."""
    import torch

    from bench.harness import train
    port = dict(ctx.hf["port"])
    port["replace"] = dict(port.get("replace", {}), param_dtype="bfloat16")
    hf = dict(ctx.hf, param_dtype="bfloat16", port=port)
    tr, ef, prog, _ = train.start(SimpleNamespace(**dict(vars(ctx), hf=hf)))
    del tr, ef
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def train_controls(ctx, rec) -> dict:
    from bench.harness import train
    ref = rec["check"]["ref"]
    bf = bf16_program(ctx)
    half = train.reference_run(ctx.hf, ctx.mix, ctx.seed, ctx.device,
                               rows=ctx.mix["rows"] // 2)
    return {"bf16_program": train.gaps(bf, ref),
            "half_batch": train.gaps(half, ref),
            "leaves": {"bf16_program": leaves(bf, ref),
                       "half_batch": leaves(half, ref)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--controls", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import train
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in man["workloads"]}[args.workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    hf = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((ROOT / "bench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        ctx = SimpleNamespace(hf=hf, mix=mix, seed=seed,
                              seconds=args.seconds, trace=False,
                              device=dev, t_start=t)
        rec = train.run(ctx)
        chk = rec["check"]
        line = {"workload": args.workload, "seed": seed,
                "correct": chk["correct"],
                "compared": {k: v for k, (v, _) in chk["compared"].items()},
                "left_out": chk["left_out"], "loss": chk["prog"]["loss"],
                "ref_loss": chk["ref"]["loss"], "run_s": time.time() - t,
                "leaves": {"program": leaves(chk["prog"], chk["ref"])},
                "memory_peak_bytes": rec["memory_peak_bytes"]}
        if args.controls:
            t1 = time.time()
            ctl = train_controls(ctx, rec)
            line["leaves"].update(ctl.pop("leaves"))
            line.update(ctl)
            line["controls_s"] = time.time() - t1
        del rec, chk
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
