#!/usr/bin/env python3
"""The dry run's and the roofline's records as one markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.roofline.analysis --mesh single
    PYTHONPATH=src python -m repro_torch.roofline.analysis --mesh multi
    PYTHONPATH=src python3 tools/dryrun_table.py [ARCH ...] [--shape S ...]

One row a cell (every applicable (arch x shape) of ``configs.all_cells``,
or of the archs and shapes named),
each value "single / multi" (the 16 x 16 and 2 x 16 x 16 meshes): per
device the argument and peak GB, the FLOP, the collective GB by kind
(all-gather / all-reduce / reduce-scatter) from ``experiments/
dryrun_torch/``; the roofline's compute, memory and collective seconds,
its dominant term and the useful-FLOP ratio from ``experiments/
roofline_torch/``.  Formats only: every number is a record's.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch.dryrun import OUT_DIR  # noqa: E402
from repro_torch.roofline.analysis import ROOFLINE_DIR  # noqa: E402

MESHES = ("single", "multi")
ABBR = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS"}


def pair(recs, fn) -> str:
    return " / ".join(fn(r) for r in recs)


def row(arch: str, shape: str) -> str:
    dr = [json.loads((OUT_DIR / f"{arch}__{shape}__{m}.json").read_text())
          for m in MESHES]
    rl = [json.loads((ROOFLINE_DIR / f"{arch}__{shape}__{m}.json")
                     .read_text()) for m in MESHES]
    coll = " / ".join(
        ", ".join(f"{ABBR[k]} {r['collectives'][k] / 1e9:.3g}"
                  for k in ABBR) for r in dr)
    return "| " + " | ".join([
        arch, shape,
        pair(dr, lambda r: f"{r['memory']['argument_size_in_bytes'] / 1e9:.3g}"),
        pair(dr, lambda r: f"{r['memory']['peak_in_bytes'] / 1e9:.3g}"),
        pair(dr, lambda r: f"{r['cost']['flops']:.3g}"),
        coll,
        pair(rl, lambda r: f"{r['compute_s']:.3g}"),
        pair(rl, lambda r: f"{r['memory_s']:.3g}"),
        pair(rl, lambda r: f"{r['collective_s']:.3g}"),
        pair(rl, lambda r: r["dominant"]),
        pair(rl, lambda r: f"{r['useful_flops_ratio']:.2f}")]) + " |"


def main(argv=None) -> int:
    words = sys.argv[1:] if argv is None else list(argv)
    shapes = words[words.index("--shape") + 1:] if "--shape" in words else []
    archs = words[:words.index("--shape")] if "--shape" in words else words
    print("| arch | shape | args GB | peak GB | FLOP | collective GB "
          "| compute s | memory s | coll. s | dominant | useful |")
    print("|" + "---|" * 11)
    for arch, shape, _, _ in configs.all_cells():
        if (not archs or arch in archs) and (not shapes or shape in shapes):
            print(row(arch, shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())
