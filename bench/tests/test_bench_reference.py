"""The plain reference against the program at tiny sizes on the CPU, in
float32: three compressed training steps."""
from __future__ import annotations

import torch

from bench.harness import train
from bench.harness import weights as W
from bench.tests import tiny


def test_three_training_steps_match():
    from repro_torch import configs
    from repro_torch.launch.train import Trainer
    hf = tiny.config()
    mix = tiny.TRAIN
    cfg = train.port_config(hf, configs)
    opt = hf["optimizer"]
    tr = Trainer(cfg, None, lr=opt["lr"], eps=opt["eps"],
                 compress=opt["compress"], device="cpu")
    mine = W.make_all(hf, 3, "cpu")
    with torch.no_grad():
        for n, t in W.flat_paths(tr.params).items():
            t.copy_(mine[n])
    ef = tr.compressor.init(tr.params)
    losses = []
    for s in range(1, 4):
        tok, lab = train.T.train_batch(mix, 3, s, hf["vocab_size"], "cpu")
        tr.params, tr.opt, ef, m = tr.step_fn(
            tr.params, tr.opt, ef, {"tokens": tok, "labels": lab})
        losses.append(float(m["loss"]))
        if s == 1:
            grad = {n: v / (1 - opt["b1"])
                    for n, v in train.leaf_norms(tr.opt.m).items()}
    change = {n: float((t - mine[n]).norm())
              for n, t in W.flat_paths(tr.params).items()}
    ref = train.reference_run(hf, mix, 3, "cpu")
    g = train.gaps({"loss": losses, "grad": grad, "change": change}, ref)
    assert g["loss_rel_gap"] < 1e-6
    assert g["grad_norm_gap"] < 1e-4 and g["change_norm_gap"] < 1e-4
    assert g["change_median_gap"] < 1e-4
    assert g["left_out"] == []
