"""RWKV-6 "Finch" 3B: attention-free, data-dependent decay. [arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab_size=65536, norm="layernorm",
    rwkv_head_size=64, rwkv_lora_dim=32,
    act_shard="dmodel",
    supports_long=True,
    fsdp_only=True,
    source="arXiv:2404.05892",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, d_ff=128, vocab_size=256,
                          rwkv_head_size=16, rwkv_lora_dim=8, loss_chunk=16,
                          compute_dtype="float32", scan_layers=False)
