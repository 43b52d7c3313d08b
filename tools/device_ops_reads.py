"""Read the device operations of ``chip_smoke.py``'s main-path run many
times under ``torch.profiler`` (on the GPU), to see how often a reading
loses records.

    python3 tools/device_ops_reads.py --reads 100

Builds the kernels, runs the main path's set-up and timed runs as
``chip_smoke.py`` does, then takes ``--reads`` readings of one more run
(the fused program's inputs kept) and prints one JSON object: each
distinct (kernels, memory ops) reading with how often it came.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as C
    from repro_torch.kernels import _build

    got = {}

    def read(backend, one_run):
        reads = C.device_ops_reads(one_run, args.reads)
        counts = collections.Counter((r["kernels"], r["memory_ops"])
                                     for r in reads)
        got["readings"] = {f"{k} kernels, {m} memory ops": n
                           for (k, m), n in counts.most_common()}
        got["reads"] = args.reads
        return {"kept": max(reads, key=lambda r: counts[
            (r["kernels"], r["memory_ops"])])}

    C.rebuilt_and_cached = read
    C.swapped_params_run = lambda *a, **k: {}
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    C.main_path(torch.device("cuda", 0), C.Card())
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
