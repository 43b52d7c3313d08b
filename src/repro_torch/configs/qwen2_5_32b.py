"""Qwen2.5-32B: GQA, QKV bias. [hf:Qwen/Qwen2.5-32B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    grad_accum=4,
    source="hf:Qwen/Qwen2.5-0.5B (family config card)",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          attn_block=32, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
