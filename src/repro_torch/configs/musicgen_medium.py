"""MusicGen-medium: decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S, d_model); targets are codebook tokens
(vocab 2048).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    norm="layernorm", mlp_kind="gelu", frontend="embeds",
    fsdp_only=True,
    source="arXiv:2306.05284",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=64,
                          attn_block=32, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
