"""The counting functions against hand-worked examples: routed slots and
not capacity, every position of a step once with no recomputation; and
the metric readers' lookup."""
from __future__ import annotations

import math

import pytest
import torch

from bench.harness import counts as C
from bench.harness.main import reader as harness_reader
from bench.harness.trace import MoeCounter
from bench.reference import model as R
from bench.tests import tiny

H100 = "NVIDIA H100 80GB HBM3"
#: one attention layer and 4 experts of width 3, top 1: d 2, one head of
#: 2, V 5
SMALL = {"num_hidden_layers": 1, "hidden_size": 2, "intermediate_size": 3,
         "num_attention_heads": 1, "num_key_value_heads": 1, "head_dim": 2,
         "vocab_size": 5, "num_local_experts": 4, "num_experts_per_tok": 1}


def reader(name):
    return harness_reader(tiny.ROOT, name)


def test_moe_launch_by_hand():
    # 3 kept rows through 2 experts of a (4 -> 5) product, bf16
    assert C.moe_launch(3, 2, 4, 5, 2, 2) == (120, 2 * 4 * 5 * 2 + 3 * 9 * 2)
    gate, up, down = C.moe_layer_call(3, 2, 4, 5, 2, 2)
    assert gate == up == (120, 134) and down == (120, 134)


def test_body_params_by_hand():
    # q, o: 2 * 2 each; k, v: 2 * 2 each; one expert's SwiGLU 3 * 2 * 3;
    # the router 2 * 4 (the other three experts are not passed)
    assert C.body_params(SMALL) == 8 + 8 + 18 + 8
    assert C.body_params(dict(SMALL, num_experts_per_tok=2)) == 42 + 18


def test_train_flop_by_hand():
    # a row of 2: 6 * (42 + 10) * 2 matmul operations, 3 pairs of
    # attention at 8, forward and backward 3x
    assert C.train_step_flop(SMALL, 1, 2) == 6 * 52 * 2 + 3 * 8 * 3
    assert C.train_step_flop(SMALL, 3, 2) == 3 * 696


def test_mfu_train_by_hand():
    """The window's steps' model operations over its seconds and the
    card's dense bf16 peak; nothing to read on a card with no peak."""
    rec = {"device_name": H100, "t0": 10.0, "t1": 12.0, "steps": 5,
           "hf": SMALL, "mix": {"rows": 3, "seq": 2}}
    assert reader("mfu.train")(rec) == pytest.approx(
        100 * 5 * 2088 / (2.0 * 989e12))
    assert reader("mfu.train")(dict(rec, device_name="cpu")) is None


def test_least_seconds_per_launch():
    peak = C.peaks(H100)
    one = [(989e12, 0), (0, 3.35e12)]
    # each launch is bound by its own larger term: 1 s + 1 s, where the
    # totals' larger term would give 1 s
    assert C.least_seconds(one, peak) == pytest.approx(2.0)


def test_moe_roofline_reads_kernel_time():
    rec = {"device_name": H100,
           "trace": {"kernel_s": {"moe_gmm_wgmma_kernel": 2.0, "gemm": 9.0}},
           "moe": {"calls": [(1000, 4, 64)], "f": 32, "w_bytes": 2}}
    launches = C.moe_layer_call(1000, 4, 64, 32, 2, 2)
    want = 100 * C.least_seconds(launches, C.peaks(H100)) / 2.0
    assert C.moe_roofline(rec) == pytest.approx(want)
    assert reader("moe_gmm_roofline.train")(rec) == pytest.approx(want)
    rec["trace"]["kernel_s"] = {"gemm": 1.0}
    assert C.moe_roofline(rec) is None


def test_counter_counts_kept_slots_not_capacity():
    """The dispatch counter reads the entries the router kept for these
    inputs: capacity 8 an expert, and an expert chosen by 12 tokens keeps
    8 of them; the slots a launch runs over (4 experts x 8) are not
    counted."""
    from repro_torch.models import moe as MOE
    hf = {"intermediate_size": 16, "param_dtype": "bfloat16"}
    cnt = MoeCounter(hf)
    try:
        T, E, k, d = 16, 4, 1, 8
        x = torch.randn(1, T, d)
        idx = torch.tensor([0] * 12 + [1] * 3 + [2]).view(1, T, k)
        gates = torch.ones(1, T, k)
        MOE._group_dispatch(x, gates, idx, E, 8)
    finally:
        cnt.remove()
    kept, used, dd = cnt.read()["calls"][0]
    assert (kept, used, dd) == (8 + 3 + 1, 3, d)
    ref = R.kept(idx[0], E, 8)
    assert int(ref.sum()) == kept
    assert MOE._group_dispatch is cnt.orig


def test_capacity_matches_the_program():
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    cfg = get_config("granite-moe-1b-a400m")
    for T in (1, 7, 24, 4096, 8192):
        assert R.capacity(T, cfg.moe_top_k, cfg.n_experts,
                          cfg.moe_capacity_factor) == capacity(T, cfg)
    assert R.capacity(4096, 8, 32, 1.25) == 1280
    assert math.ceil(4096 * 8 * 1.25 / 32) == 1280


def test_reader_falls_back_to_the_name_before_the_dot(tmp_path):
    """A metric with no reader of its own name is read by the one its
    name's first part names; one of its own name comes first."""
    (tmp_path / "bench" / "metrics").mkdir(parents=True)
    (tmp_path / "bench" / "metrics" / "idle.py").write_text(
        "def read(rec):\n    return 1.0\n")
    assert harness_reader(tmp_path, "idle.serve")({}) == 1.0
    (tmp_path / "bench" / "metrics" / "idle.serve.py").write_text(
        "def read(rec):\n    return 2.0\n")
    assert harness_reader(tmp_path, "idle.serve")({}) == 2.0
    assert harness_reader(tmp_path, "idle.train")({}) == 1.0
    rec = {"trace": {"busy_s": 3.0, "window_s": 4.0}}
    assert reader("device_idle.train")(rec) == pytest.approx(25.0)


def test_kept_matches_the_program_dispatch():
    """The reference's capacity rule keeps the entries the program's
    dispatch keeps, on skewed routing."""
    from repro_torch.models import moe as MOE
    g = torch.Generator().manual_seed(5)
    T, E, k, C_ = 40, 4, 2, 16
    p = torch.tensor([0.7, 0.1, 0.1, 0.1])
    first = torch.multinomial(p, T, replacement=True, generator=g)
    second = (first + 1 + torch.randint(0, E - 1, (T,), generator=g)) % E
    idx = torch.stack([first, second], -1)
    out = MOE._group_dispatch(torch.randn(1, T, 8), torch.ones(1, T, k),
                              idx[None], E, C_)
    _, slot, keep, t_s, _ = out
    order = torch.argsort(idx.reshape(-1), stable=True)
    prog = torch.zeros(T * k, dtype=torch.bool)
    prog[order] = keep[0]
    assert torch.equal(prog.view(T, k), R.kept(idx, E, C_))
    assert not bool(prog.all())
