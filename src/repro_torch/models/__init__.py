"""Model definitions of the port: dense decoder-only serving (prefill and
decode) so far."""
from .model import (apply_decode, apply_prefill, init_cache,  # noqa: F401
                    init_params)
