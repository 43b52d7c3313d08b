"""Model definitions of the port: training of dense decoders (and the
``embeds`` frontend of audio and VLM), and serving (prefill and decode) of
dense, MoE, hybrid Mamba and RWKV-6 decoders."""
from .model import (apply_decode, apply_prefill, apply_train,  # noqa: F401
                    init_cache, init_params)
