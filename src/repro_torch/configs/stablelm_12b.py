"""StableLM-2-12B. [hf:stabilityai/stablelm-2-12b; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    norm="layernorm", mlp_kind="swiglu", rope_theta=10000.0,
    grad_accum=2,
    fsdp_only=True,
    source="hf:stabilityai/stablelm-2-1_6b family (12B row of assignment)",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          attn_block=32, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
