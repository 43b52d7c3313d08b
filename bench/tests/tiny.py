"""A checkout of the benchmark at tiny sizes, for the CPU tests: the
repository's metric readers, a tiny configuration of the training cell's
model (float32 compute, the program's capacity factor, so experts drop
entries), a small traffic file and a manifest naming them."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

MOE = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=32,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
           num_local_experts=8, num_experts_per_tok=2,
           compute_dtype="float32",
           runs={"tie_word_embeddings": False, "embedding_multiplier": 1.0,
                 "attention_multiplier": 0.25, "residual_multiplier": 1.0,
                 "logits_scaling": 1.0},
           port={"arch": "granite-moe-1b-a400m", "replace": {
               "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
               "head_dim": 16, "d_ff": 32, "vocab_size": 256,
               "n_experts": 8, "moe_top_k": 2, "compute_dtype": "float32",
               "attn_block": 32, "loss_chunk": 16}},
           limits={"loss_rel_gap": 1e-4, "grad_norm_gap": 1e-3,
                   "change_norm_gap": 1e-3, "change_median_gap": 1e-3})
TRAIN = {"kind": "train", "rows": 2, "seq": 32, "reference_steps": 3}


def config() -> dict:
    """The tiny configuration dict."""
    gr = json.loads((BENCH / "configs" /
                     "granite-moe-1b-a400m.json").read_text())
    gr.update(copy.deepcopy(MOE))
    return gr


def make_root(path: Path) -> Path:
    """Writes a tiny checkout of the benchmark under ``path``."""
    shutil.copytree(BENCH / "metrics", path / "bench" / "metrics")
    (path / "bench" / "configs").mkdir(parents=True)
    (path / "bench" / "traffic").mkdir(parents=True)
    (path / "bench" / "configs" / "moe.json").write_text(json.dumps(config()))
    (path / "bench" / "traffic" / "train.json").write_text(json.dumps(TRAIN))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": "moe", "source": "tiny", "file":
                       "bench/configs/moe.json", "reduced": [],
                       "why": "tiny"}]
    for w in man["workloads"]:
        w.update(config="moe", traffic="train")
    (path / "BENCHMARK.json").write_text(json.dumps(man))
    return path


def train_cell() -> str:
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(w["name"] for w in man["workloads"]
                if w["traffic"] == "train")


#: faults planted under the timed path, by name (see ``breaks``)
RUNNER = r'''
import sys, time
t = time.time()
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
torch.set_num_threads(2)
from bench.tests.tiny import breaks
from bench.harness.main import main
breaks(sys.argv[3])
sys.exit(main(sys.argv[4:], t, __import__("pathlib").Path(sys.argv[2]),
              device="cpu"))
'''


def breaks(name: str) -> None:
    """Plants fault ``name`` in the program under the timed path:
    ``frozen`` makes the training step return its state unchanged,
    ``half_batch`` drops half of each batch's rows and takes the mean
    over the rest; ``none`` plants nothing."""
    if name == "none":
        return
    from repro_torch.launch import train as LT
    real_build = LT.Trainer._build_step

    def build(self, lr, eps):
        step = real_build(self, lr, eps)
        if name == "half_batch":
            def half(params, opt, ef, batch):
                rows = batch["tokens"].shape[0] // 2
                return step(params, opt, ef,
                            {k: v[:rows] for k, v in batch.items()})
            return half

        def frozen(params, opt, ef, batch):
            (_, m), _ = LT.value_and_grad(params, self.cfg, batch)
            return params, opt, ef, m
        return frozen
    if name not in ("half_batch", "frozen"):
        raise ValueError(f"no fault {name!r}")
    LT.Trainer._build_step = build


def run(root: Path, argv: list[str], fault: str = "none"):
    """One run of ``bench/harness/main.py`` at ``root`` on the CPU, in a
    fresh interpreter (so nothing the test process loaded is in its
    ``sys.modules``).  Returns (exit code, stdout, stderr)."""
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", RUNNER, str(ROOT), str(root),
                        fault, *argv], capture_output=True, text=True,
                       env=env, timeout=300)
    return p.returncode, p.stdout, p.stderr


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
