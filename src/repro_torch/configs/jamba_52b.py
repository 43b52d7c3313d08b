"""Jamba-v0.1 52B: Mamba + attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Layer layout per the paper: blocks of 8 layers with one attention layer
(offset 4) and MoE replacing the MLP on every other layer.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    n_experts=16, moe_top_k=2, moe_period=2, moe_offset=1,
    moe_ep=True,  # experts over the model axis (16 % 16): see §Perf
    attn_period=8, attn_offset=4,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    act_shard="dmodel",
    supports_long=True, scan_layers=False,  # heterogeneous stack -> unrolled
    grad_accum=4,
    source="arXiv:2403.19887",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          n_experts=4, moe_top_k=2,
                          moe_capacity_factor=8.0,  # no drops in smoke tests attn_period=4,
                          attn_offset=1, attn_block=32, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
