"""perfbench CLI: compare snapshots, rerun benches, bisect regressions.

  PYTHONPATH=src python -m repro_torch.perfbench compare BASE CAND [CAND...]
  PYTHONPATH=src python -m repro_torch.perfbench run BENCH \
      --repeats 3 --out rerun.json
  PYTHONPATH=src python -m repro_torch.perfbench bisect GOOD..BAD \
      --bench BENCH --baseline SNAPSHOT.json

``run`` and ``bisect`` take a bench of ``SNAPSHOT_RUNNERS``; while that
registry is empty they exit 2 on any name.

Exit codes: 0 gate passed / command ok, 1 regression(s), 2 usage or
runtime error.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
from pathlib import Path

from .bisect import bisect_cli
from .compare import compare, format_report
from .metrics import load_snapshot
from .trajectory import append_entry

#: rerunnable snapshot benches: name -> (module, callable).  Each callable
#: has the repo bench signature ``f(smoke=None, out_path=...) -> dict``.
#: The JAX package's entries name its own benches, which import JAX; the
#: port's benchmark registers the port's benches here.  Until then the
#: registry is empty and ``run`` / ``bisect`` refuse every name (exit 2).
SNAPSHOT_RUNNERS: dict[str, tuple[str, str]] = {}


def _unknown(name: str) -> str:
    return (f"unknown bench {name!r}; known: {sorted(SNAPSHOT_RUNNERS)} "
            "(perfbench.__main__.SNAPSHOT_RUNNERS)")


def run_bench(name: str, *, repeats: int = 3, smoke: bool = True) -> dict:
    """Re-run one registered bench ``repeats`` times and wrap the results
    in the repeats envelope the compare loader pools into per-metric CV."""
    if name not in SNAPSHOT_RUNNERS:
        raise KeyError(_unknown(name))
    module, func = SNAPSHOT_RUNNERS[name]
    fn = getattr(importlib.import_module(module), func)
    results = []
    for i in range(max(1, repeats)):
        with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
            results.append(fn(smoke=smoke,
                              out_path=Path(tmp) / f"{name}.json"))
    return {"bench": name, "mode": "smoke" if smoke else "full",
            "repeats": results}


def _add_gate_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--threshold", type=float, default=0.10,
                   help="noise floor every metric gets (default 0.10)")
    p.add_argument("--k", type=float, default=3.0,
                   help="CV multiplier for the variance gate (default 3)")
    p.add_argument("--only", action="append", default=[],
                   help="gate only metric paths matching this "
                        "glob/substring (repeatable)")
    p.add_argument("--skip", action="append", default=[],
                   help="ignore metric paths matching this "
                        "glob/substring (repeatable)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perfbench",
        description="variance-aware perf gate over BENCH_*.json snapshots")
    sub = ap.add_subparsers(dest="cmd", required=True)

    cp = sub.add_parser("compare", help="gate candidate vs baseline")
    cp.add_argument("base", help="baseline snapshot JSON")
    cp.add_argument("cand", nargs="+",
                    help="candidate snapshot(s); several files pool into "
                         "one sample set")
    _add_gate_flags(cp)
    cp.add_argument("--verbose", action="store_true",
                    help="print within-gate metrics too")
    cp.add_argument("--trajectory", metavar="PATH",
                    help="append the verdict to this ledger")
    cp.add_argument("--bench", default=None,
                    help="bench name recorded in the trajectory entry")
    cp.add_argument("--json", action="store_true",
                    help="print the machine-readable verdict")

    rp = sub.add_parser("run", help="re-run a bench at N repeats")
    rp.add_argument("bench", help=f"one of {sorted(SNAPSHOT_RUNNERS)}")
    rp.add_argument("--repeats", type=int, default=3)
    rp.add_argument("--full", action="store_true",
                    help="full mode instead of smoke")
    rp.add_argument("--out", default=None,
                    help="write the repeats envelope here "
                         "(default <bench>_rerun.json)")

    bp = sub.add_parser("bisect",
                        help="find the first bad commit in GOOD..BAD")
    bp.add_argument("range", help="good..bad commit range")
    bp.add_argument("--bench", required=True,
                    help=f"one of {sorted(SNAPSHOT_RUNNERS)}")
    bp.add_argument("--baseline", required=True,
                    help="baseline snapshot the gate compares against")
    bp.add_argument("--repeats", type=int, default=1)
    bp.add_argument("--repo", default=".")
    _add_gate_flags(bp)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "compare":
        try:
            base = load_snapshot(args.base)
            cands = [load_snapshot(p) for p in args.cand]
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot load snapshot: {e}", file=sys.stderr)
            return 2
        res = compare([base], cands, threshold=args.threshold, k=args.k,
                      only=args.only, skip=args.skip)
        print(format_report(res, verbose=args.verbose))
        if args.json:
            print(json.dumps(res.to_dict(), indent=1))
        if args.trajectory:
            append_entry(
                args.trajectory,
                bench=args.bench or Path(args.base).stem,
                snapshot=cands[0] if len(cands) == 1
                else {"repeats": cands},
                verdict=res.to_dict())
        return 0 if res.passed else 1
    if args.cmd == "run":
        try:
            snap = run_bench(args.bench, repeats=args.repeats,
                             smoke=not args.full)
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2
        out = Path(args.out) if args.out else Path(
            f"{args.bench}_rerun.json")
        out.write_text(json.dumps(snap, indent=1) + "\n")
        print(f"wrote {out} ({args.repeats} repeat(s))")
        return 0
    if args.cmd == "bisect":
        if args.bench not in SNAPSHOT_RUNNERS:
            # every probe would rerun this bench: refuse before checking
            # any commit out
            print(_unknown(args.bench), file=sys.stderr)
            return 2
        try:
            return bisect_cli(args)
        except (ValueError, OSError) as e:
            print(f"bisect failed: {e}", file=sys.stderr)
            return 2
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
