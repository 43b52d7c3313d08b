"""Qwen3-8B: qk-norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    fsdp_only=True,
    source="hf:Qwen/Qwen3-8B",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          attn_block=32, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
