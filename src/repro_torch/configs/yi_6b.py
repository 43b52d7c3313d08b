"""Yi-6B: llama-arch GQA. [arXiv:2403.04652; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5_000_000.0,
    fsdp_only=True,
    source="arXiv:2403.04652",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          attn_block=32, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
