"""Model definitions of the port: serving (prefill and decode) of dense,
MoE, hybrid Mamba and RWKV-6 decoders."""
from .model import (apply_decode, apply_prefill, init_cache,  # noqa: F401
                    init_params)
