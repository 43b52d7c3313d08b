"""Granite-3.0 1B-A400M: MoE 32 experts top-8, tiny expert FFNs.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    n_experts=32, moe_top_k=8,
    fsdp_only=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=32, vocab_size=256,
                          n_experts=8, moe_top_k=2,
                          moe_capacity_factor=8.0,  # no drops in smoke tests attn_block=32,
                          loss_chunk=16, compute_dtype="float32",
                          scan_layers=False)
