"""The comparison that decides ``correct`` fails what it has to fail, at
tiny sizes on the CPU: a run with the timed path broken underneath (a
training step that returns its state unchanged; half of each batch left
out, the mean over the rest), and the control, the program one precision
step below the configuration's (its bfloat16 master weights)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench import calibrate
from bench.harness import train
from bench.tests import tiny

SEED = 2 ** 31 + 99


def argv(cell: str) -> list[str]:
    return ["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
            "--trace", "0"]


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_broken_path_is_not_correct(tmp_path, fault):
    root = tiny.make_root(tmp_path)
    rc, out, err = tiny.run(root, argv(tiny.train_cell()), fault)
    assert rc == 0, err[-3000:]
    line = tiny.last_line(out)
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_train_control_fails():
    """The program with bfloat16 master weights, and the reference with
    half of each batch, each fail one of the numbers compared."""
    hf = tiny.config()
    ctx = SimpleNamespace(hf=hf, mix=tiny.TRAIN, seed=SEED,
                          device=torch.device("cpu"))
    ref = train.reference_run(hf, tiny.TRAIN, SEED, "cpu")
    got = calibrate.train_controls(ctx, {"check": {"ref": ref}})
    lim = hf["limits"]
    for g in (got["bf16_program"], got["half_batch"]):
        assert any(g[k] > lim[k] for k in lim)
