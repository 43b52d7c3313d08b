"""Operations and bytes the work needs, and the chip's peaks.

These count what the inputs need, whatever implements the layer, so a
later change to a kernel, its padding or its dispatch leaves the
yardstick where it is:

- an expert matmul launch (gate, up or down) does ``2 * slots * d * f``
  operations for the routed slots the router kept, not the padded
  capacity, and reads each expert weight that has a slot once, the kept
  rows in and writes them out;
- a training step's model operations are ``6 * N`` a token for the
  weights it passes (the experts it is routed to, the head) and causal
  attention forward and backward (``3 *`` the forward), not the
  recomputation.

``N`` counts the active weights without the embedding table, which is a
lookup; every layer is attention followed by top-k experts.  Peaks are NVIDIA's data-sheet figures for the part, dense.
"""
from __future__ import annotations

#: device name -> dense bf16 operations/s and HBM bytes/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "hbm": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def body_params(hf: dict) -> int:
    """Active weights a token passes, outside the embedding and the
    head: each layer's attention projections, its router and its top-k
    experts."""
    from .weights import head_dim
    d, f = hf["hidden_size"], hf["intermediate_size"]
    H, Kv, hd = hf["num_attention_heads"], hf["num_key_value_heads"], \
        head_dim(hf)
    k, E = hf["num_experts_per_tok"], hf["num_local_experts"]
    attn = d * H * hd * 2 + d * Kv * hd * 2
    return hf["num_hidden_layers"] * (attn + 3 * d * f * k + d * E)


def attn_pair_flop(hf: dict) -> int:
    """Operations of one query against one key, over every head of every
    layer: the score and the value product."""
    from .weights import head_dim
    return 4 * hf["num_attention_heads"] * head_dim(hf) * \
        hf["num_hidden_layers"]


def train_step_flop(hf: dict, rows: int, seq: int) -> int:
    """One step of ``rows`` rows of ``seq`` positions: forward and
    backward of the body and the head for every position, causal
    attention forward and backward."""
    d, V = hf["hidden_size"], hf["vocab_size"]
    pairs = seq * (seq + 1) // 2
    return rows * (6 * (body_params(hf) + d * V) * seq
                   + 3 * attn_pair_flop(hf) * pairs)


def moe_launch(slots: int, experts_used: int, d_in: int, d_out: int,
               w_bytes: int, a_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one grouped expert matmul launch over
    ``slots`` kept rows."""
    flop = 2 * slots * d_in * d_out
    nbytes = experts_used * d_in * d_out * w_bytes + \
        slots * (d_in + d_out) * a_bytes
    return flop, nbytes


def moe_layer_call(slots: int, experts_used: int, d: int, f: int,
                   w_bytes: int, a_bytes: int) -> list[tuple[int, int]]:
    """(operations, bytes) of each of one experts layer's three launches:
    gate and up (d -> f), down (f -> d)."""
    return [moe_launch(slots, experts_used, d, f, w_bytes, a_bytes),
            moe_launch(slots, experts_used, d, f, w_bytes, a_bytes),
            moe_launch(slots, experts_used, f, d, w_bytes, a_bytes)]


def least_seconds(launches, peak: dict) -> float:
    """The roofline's time of a list of (operations, bytes) launches: each
    launch bound by the larger of its two terms."""
    return sum(max(fl / peak["bf16"], by / peak["hbm"])
               for fl, by in launches)


def moe_roofline(rec: dict) -> float | None:
    """The expert matmul kernels' share of their roofline, in %: the least
    time of the window's launches, counted from each dispatch's kept
    slots and experts used (:func:`moe_layer_call`), over the summed
    device time of the kernels named ``moe_gmm``."""
    tr, moe = rec.get("trace"), rec.get("moe")
    peak = peaks(rec.get("device_name", ""))
    if not tr or not moe or not moe["calls"] or not peak:
        return None
    secs = sum(s for n, s in tr["kernel_s"].items() if "moe_gmm" in n)
    if secs <= 0:
        return None
    launches = [x for kept, used, d in moe["calls"]
                for x in moe_layer_call(kept, used, d, moe["f"],
                                        moe["w_bytes"], 2)]
    return 100.0 * least_seconds(launches, peak) / secs


__all__ = ["PEAKS", "attn_pair_flop", "body_params", "least_seconds",
           "moe_launch", "moe_layer_call", "moe_roofline", "peaks",
           "train_step_flop"]
