"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  Build and
kernel caches go to fixed directories under ``build/`` in the checkout.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
