"""Model/config schema shared by all architectures.

Every assigned architecture gets one file in this package defining
``CONFIG = ModelConfig(...)`` with the exact published hyper-parameters, plus
a ``tiny()`` reduced config of the same family for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp_kind: str = "swiglu"       # swiglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple | None = None   # (t, h, w) rotary pair split (Qwen2-VL)
    frontend: str = "tokens"       # tokens | embeds (audio/vlm stubs)
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_period: int = 1            # MoE at layers where i % period == offset
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01
    moe_z_coeff: float = 1e-3
    moe_dense_mode: bool = False   # tiny-config smoke fallback
    moe_ep: bool = False           # expert parallelism: experts sharded over
                                   # the model axis, dispatch via all-to-all
                                   # (requires n_experts % TP == 0)
    # --- hybrid (Jamba): attention at layers where i % attn_period == attn_offset
    attn_period: int = 1
    attn_offset: int = 0
    # --- Mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0         # 0 -> ceil(d_model / 16)
    # --- RWKV ---
    rwkv_head_size: int = 64
    rwkv_lora_dim: int = 32
    # --- execution knobs ---
    attn_block: int = 512          # query block for flash attention
    loss_chunk: int = 512          # seq chunk for vocab cross-entropy
    rwkv_chunk: int = 64           # WKV scan segment (checkpointed)
    mamba_chunk: int = 64          # SSM scan segment (checkpointed)
    act_shard: str = "seq"         # layer-boundary acts: seq | dmodel | batch
    scan_layers: bool = True
    remat: str = "full"            # none | full | dots
    grad_accum: int = 1            # microbatches per step (activation memory)
    fsdp_only: bool = False        # train: shard params over ALL mesh axes,
                                   # no tensor parallelism (see EXPERIMENTS
                                   # §Perf: wins when per-layer weight bytes
                                   # < per-layer activation-gather bytes)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- meta ---
    supports_long: bool = False    # may run the long_500k cell
    source: str = ""

    # ------------------------------------------------------------- derived --
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or math.ceil(self.d_model / 16)

    def mixer_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "rwkv"
        if self.family == "hybrid":
            return "attn" if i % self.attn_period == self.attn_offset else "mamba"
        return "attn"

    def channel_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "rwkv_cm"
        if self.n_experts and i % self.moe_period == self.moe_offset:
            return "moe"
        return "mlp"

    def layer_kinds(self) -> list[tuple[str, str]]:
        return [(self.mixer_kind(i), self.channel_kind(i))
                for i in range(self.n_layers)]

    def is_homogeneous(self) -> bool:
        kinds = self.layer_kinds()
        return all(k == kinds[0] for k in kinds)

    @property
    def n_attn_layers(self) -> int:
        return sum(1 for m, _ in self.layer_kinds() if m == "attn")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (for 6ND model-flops and memory budgeting).
    def param_counts(self) -> dict:
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        n = {"embed": V * d, "head": d * V, "mixer": 0, "channel": 0}
        for (mix, ch) in self.layer_kinds():
            if mix == "attn":
                n["mixer"] += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                    + (self.n_heads * hd) * d
                if self.qkv_bias:
                    n["mixer"] += self.n_heads * hd + 2 * self.n_kv_heads * hd
            elif mix == "mamba":
                di = self.mamba_expand * d
                ds, dtr = self.mamba_d_state, self.dt_rank
                n["mixer"] += d * 2 * di + self.mamba_d_conv * di + \
                    di * (dtr + 2 * ds) + dtr * di + di * ds + 2 * di + di * d
            elif mix == "rwkv":
                r = self.rwkv_lora_dim
                n["mixer"] += 5 * d * d + d * 5 * r + 5 * r * d + \
                    d * 2 * r + 2 * r * d + 4 * d
            if ch == "mlp":
                n["channel"] += 3 * d * dff if self.mlp_kind == "swiglu" else 2 * d * dff
            elif ch == "moe":
                n["channel"] += d * self.n_experts + self.n_experts * 3 * d * dff
            elif ch == "rwkv_cm":
                n["channel"] += d * dff + dff * d + d * d + 2 * d
        n["total"] = sum(v for k, v in n.items() if k != "total")
        return n

    def active_param_counts(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        n = self.param_counts()
        total = n["total"]
        if self.n_experts:
            moe_layers = sum(1 for _, c in self.layer_kinds() if c == "moe")
            full = moe_layers * self.n_experts * 3 * self.d_model * self.d_ff
            active = moe_layers * self.moe_top_k * 3 * self.d_model * self.d_ff
            total = total - full + active
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Per-assignment skip rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §5)"
    return True, ""
