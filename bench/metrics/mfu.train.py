"""Model operations of the window's steps (forward and backward, not the
recomputation) over the window's seconds and the card's dense bf16 peak,
in %."""
from bench.harness.counts import peaks, train_step_flop


def read(rec):
    peak = peaks(rec["device_name"])
    if not peak:
        return None
    mix = rec["mix"]
    flop = rec["steps"] * train_step_flop(rec["hf"], mix["rows"], mix["seq"])
    return 100.0 * flop / ((rec["t1"] - rec["t0"]) * peak["bf16"])
