"""Qwen2-VL-2B: M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, S, d_model) plus M-RoPE positions (3, B, S).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    mrope_sections=(16, 24, 24),  # per-modality rotary-pair split (sum = hd/2)
    frontend="embeds", rope_theta=1_000_000.0,
    fsdp_only=True,
    source="arXiv:2409.12191",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          mrope_sections=(2, 3, 3), attn_block=32,
                          loss_chunk=16, compute_dtype="float32",
                          scan_layers=False)
