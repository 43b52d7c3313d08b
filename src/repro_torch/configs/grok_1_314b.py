"""Grok-1 314B: MoE, 8 experts top-2, GQA. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, moe_top_k=2,
    grad_accum=16,
    source="hf:xai-org/grok-1 (unverified tier)",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          n_experts=4, moe_top_k=2,
                          moe_capacity_factor=8.0,  # no drops in smoke tests attn_block=32,
                          loss_chunk=16, compute_dtype="float32",
                          scan_layers=False)
