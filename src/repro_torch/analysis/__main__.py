"""CLI: ``python -m repro_torch.analysis {lint,hlo,typecheck}``.

  lint [PATHS...] [--baseline FILE] [--update-baseline] [--json OUT]
      Run the datapath linter (default: ``src/repro_torch`` against
      ``analysis_baseline_torch.json``; ``analysis_baseline.json`` is the
      JAX package's).  With a baseline, pre-existing diagnostics
      (enumerated per rule+file) pass; NEW ones fail (exit 1).
  hlo grep KERNEL PATTERN [LIMIT]
      Grep the SASS of one built kernel library (``cuobjdump -sass``).
  hlo buffers ARCH SHAPE [MIN_BYTES] [--layers N]
      Record one step of the port on the card and rank the allocations
      live at its peak.
  typecheck [--baseline FILE] [--update-baseline]
      Run mypy over ``src/repro_torch/api`` and
      ``src/repro_torch/core/sched`` against ``mypy_baseline_torch.txt``.
      Skips cleanly (exit 0) when mypy is not installed, as the JAX
      package's does.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess

from .diagnostics import Baseline, render_text, to_json
from .linter import lint_paths

DEFAULT_LINT_PATHS = ["src/repro_torch"]
DEFAULT_BASELINE = "analysis_baseline_torch.json"
DEFAULT_MYPY_BASELINE = "mypy_baseline_torch.txt"
TYPED_PATHS = ["src/repro_torch/api", "src/repro_torch/core/sched"]


# ----------------------------------------------------------------- lint ----
def cmd_lint(args) -> int:
    diags = lint_paths(args.paths or DEFAULT_LINT_PATHS)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(to_json(diags))
    base = Baseline.load(args.baseline)
    if args.update_baseline:
        Baseline.from_diags(diags).save(args.baseline)
        print(f"baseline updated: {args.baseline} "
              f"({len(diags)} diagnostic(s) enumerated)")
        return 0
    fresh = base.new(diags)
    if not fresh:
        known = len(diags)
        print("lint: no new diagnostics"
              + (f" ({known} baseline-enumerated)" if known else ""))
        return 0
    print(render_text(fresh))
    print(f"lint: {len(fresh)} NEW diagnostic(s) not in {args.baseline}")
    return 1


# ------------------------------------------------------------------ hlo ----
def cmd_hlo(args) -> int:
    from . import hlo
    if args.hlo_cmd == "grep":
        return hlo.main_grep(args.kernel, args.pattern, args.limit)
    return hlo.main_buffers(args.arch, args.shape, args.min_bytes,
                            args.layers)


# ------------------------------------------------------------ typecheck ----
def _strip_linenos(lines: list[str]) -> list[str]:
    """``path:123: error: msg`` -> ``path: error: msg`` so edits above an
    existing error don't churn the baseline."""
    return [re.sub(r"^([^:]+):\d+(:\d+)?:", r"\1:", ln) for ln in lines]


def cmd_typecheck(args) -> int:
    if shutil.which("mypy") is None:
        print("typecheck: mypy not installed; skipping")
        return 0
    proc = subprocess.run(
        ["mypy", "--config-file", "mypy.ini", *TYPED_PATHS],
        capture_output=True, text=True)
    errors = [ln for ln in proc.stdout.splitlines() if ": error:" in ln]
    normalized = sorted(set(_strip_linenos(errors)))
    if args.update_baseline:
        with open(args.baseline, "w", encoding="utf-8") as fh:
            fh.write("\n".join(normalized) + ("\n" if normalized else ""))
        print(f"baseline updated: {args.baseline} "
              f"({len(normalized)} error pattern(s))")
        return 0
    try:
        with open(args.baseline, encoding="utf-8") as fh:
            known = set(ln.strip() for ln in fh if ln.strip())
    except FileNotFoundError:
        known = set()
    fresh = [ln for ln in normalized if ln not in known]
    if not fresh:
        print(f"typecheck: no new errors "
              f"({len(normalized)} baseline-enumerated)")
        return 0
    print("\n".join(fresh))
    print(f"typecheck: {len(fresh)} NEW error pattern(s) "
          f"not in {args.baseline}")
    return 1


# ----------------------------------------------------------------- main ----
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="datapath linter")
    lp.add_argument("paths", nargs="*", help=f"default: {DEFAULT_LINT_PATHS}")
    lp.add_argument("--baseline", default=DEFAULT_BASELINE)
    lp.add_argument("--update-baseline", action="store_true")
    lp.add_argument("--json", default=None,
                    help="also write diagnostics as JSON (CI artifact)")
    lp.set_defaults(fn=cmd_lint)

    hp = sub.add_parser("hlo", help="kernel SASS grep / step buffers")
    hsub = hp.add_subparsers(dest="hlo_cmd", required=True)
    hg = hsub.add_parser("grep")
    for a in ("kernel", "pattern"):
        hg.add_argument(a)
    hg.add_argument("limit", nargs="?", type=int, default=20)
    hb = hsub.add_parser("buffers")
    for a in ("arch", "shape"):
        hb.add_argument(a)
    hb.add_argument("min_bytes", nargs="?", type=float, default=100e6)
    hb.add_argument("--layers", type=int, default=None,
                    help="layers kept (default: all of the config's)")
    hp.set_defaults(fn=cmd_hlo)

    tp = sub.add_parser("typecheck", help="mypy over the typed subset")
    tp.add_argument("--baseline", default=DEFAULT_MYPY_BASELINE)
    tp.add_argument("--update-baseline", action="store_true")
    tp.set_defaults(fn=cmd_typecheck)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
