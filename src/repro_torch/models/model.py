"""Model assembly for serving: the JAX package's ``models/model.py`` as
plain functions over a dict of tensors.

Entry points:
  - ``init_params(gen, cfg, device=None)``          parameters for the model
  - ``apply_prefill(params, cfg, batch, max_len)``   -> (logits_last, cache)
  - ``apply_decode(params, cfg, cache, batch, pos)`` -> (logits, cache)
  - ``init_cache(cfg, B, max_len, dtype, device)``   decode-state list

Layer structure as in the JAX package: a pre-norm mixer (attention or
Mamba) with residual, then a pre-norm channel (MLP or MoE) with residual,
each layer's kinds from ``cfg.mixer_kind(i)`` / ``cfg.channel_kind(i)``;
dense, MoE (Granite) and hybrid (Jamba) stacks all run.  Differences that
change no result:
  - layers are always a list; the JAX package stacks homogeneous layers for
    ``lax.scan`` (:func:`repro_torch.convert.model_params_from_numpy` takes
    either layout);
  - ``repro.parallel.ctx.constrain_acts`` is a no-op on one device and is
    dropped;
  - ``apply_decode`` updates the caches in place and returns them: the KV
    cache rows, the conv state, and the SSM state, which the scan kernel
    writes where it read it.
The RWKV mixer and channel raise ``NotImplementedError`` naming their
ROADMAP slice; training (``apply_train``) is the training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import _device

from . import attention as A
from . import mamba as M
from . import moe as X
from .layers import (embed, embed_init, linear, linear_init, mlp, mlp_init,
                     norm_apply, norm_init)

Params = Any

#: layer kinds of other model families -> the ROADMAP slice that ports them
_SLICES = {"rwkv": "the RWKV-6 slice (rwkv6_wkv)",
           "rwkv_cm": "the RWKV-6 slice (rwkv6_wkv)"}

#: config dtype names -> torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _ported_only(cfg, i: int) -> None:
    for kind in (cfg.mixer_kind(i), cfg.channel_kind(i)):
        if kind in _SLICES:
            raise NotImplementedError(
                f"{cfg.name}: layer {i} kind {kind!r} is not ported yet: "
                f"ROADMAP Queue 1, {_SLICES[kind]}")


def _generator(gen, device) -> torch.Generator:
    """An int seeds a new generator on ``device`` (so a large model is drawn
    where it lives); a ``torch.Generator`` is used as given."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


# ================================================================= layers ====
def layer_init(gen, cfg, i: int, dtype, device=None):
    _ported_only(cfg, i)
    kw = dict(dtype=dtype, device=device)
    p = {"norm1": norm_init(cfg.norm, cfg.d_model, **kw),
         "norm2": norm_init(cfg.norm, cfg.d_model, **kw)}
    if cfg.mixer_kind(i) == "attn":
        p["attn"] = A.attn_init(gen, cfg, **kw)
    else:
        p["mamba"] = M.mamba_init(gen, cfg, **kw)
    if cfg.channel_kind(i) == "mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)
    else:
        p["moe"] = X.moe_init(gen, cfg, **kw)
    return p


def layer_cache_init(cfg, i: int, B: int, max_len: int, dtype, device=None):
    _ported_only(cfg, i)
    if cfg.mixer_kind(i) == "attn":
        shape = (B, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    di = cfg.mamba_expand * cfg.d_model
    return {"conv": torch.zeros((B, cfg.mamba_d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((B, di, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}


def _channel(p, x, cfg, i: int):
    h = norm_apply(cfg.norm, p["norm2"], x)
    if cfg.channel_kind(i) == "mlp":
        return x + mlp(p["mlp"], h, cfg.mlp_kind)
    h, _ = X.moe_apply(p["moe"], h, cfg)
    return x + h


def layer_decode(p, cache, x, cfg, i: int, pos: int):
    """Single-token step. x: (B, 1, d); pos: int. -> (x, cache), the
    cache's tensors updated in place."""
    h = norm_apply(cfg.norm, p["norm1"], x)
    if cfg.mixer_kind(i) == "attn":
        h, _, _ = A.attn_decode(p["attn"], h, cfg, cache["k"], cache["v"],
                                pos)
    else:
        h, (conv, _) = M.mamba_apply(p["mamba"], h, cfg, cache["conv"],
                                     cache["ssm"])
        cache["conv"].copy_(conv)
    return _channel(p, x + h, cfg, i), cache


# ================================================================== model ====
def init_params(gen, cfg, device=None) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default
    ``cuda:0``; raises without a GPU unless given ``device="cpu"``).
    ``gen`` is a ``torch.Generator`` or an int seed."""
    dev = _device.resolve(device)
    gen = _generator(gen, dev)
    dtype = DTYPES[cfg.param_dtype]
    kw = dict(dtype=dtype, device=dev)
    p: dict = {}
    if cfg.frontend == "tokens":
        p["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, **kw)
    else:  # embeds frontend stub: inputs arrive as (B, S, d_model)
        p["in_norm"] = norm_init(cfg.norm, cfg.d_model, **kw)
    p["layers"] = [layer_init(gen, cfg, i, **kw) for i in range(cfg.n_layers)]
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, **kw)
    p["head"] = linear_init(gen, cfg.d_model, cfg.vocab_size, **kw)
    return p


def _positions(cfg, batch, B, S, device):
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(B, S)
    if cfg.mrope_sections:  # text default: t = h = w = linear index
        pos = pos[None].expand(3, B, S)
    return pos


def embed_inputs(params, cfg, batch):
    """Token ids or precomputed frontend embeddings -> (B, S, d) activations
    in the compute dtype."""
    cdt = DTYPES[cfg.compute_dtype]
    if cfg.frontend == "tokens":
        return embed(params["embed"], batch["tokens"]).to(cdt)
    return norm_apply(cfg.norm, params["in_norm"], batch["embeds"].to(cdt))


def init_cache(cfg, B: int, max_len: int, dtype=torch.bfloat16, device=None):
    return [layer_cache_init(cfg, i, B, max_len, dtype, device)
            for i in range(cfg.n_layers)]


def apply_prefill(params, cfg, batch, max_len: int | None = None):
    """Processes the prompt; returns (logits_last (B, V), cache at len S).

    The returned attention caches have length ``max_len`` (default S) so
    decode can write in place; S > ``max_len`` raises, as the JAX package's
    cache update fails there.
    """
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds the cache length "
                         f"max_len={max_len}")
    positions = _positions(cfg, batch, B, S, x.device)
    cdt = x.dtype
    cache = []
    for i, lp in enumerate(params["layers"]):
        lc = layer_cache_init(cfg, i, B, max_len, cdt, x.device)
        h = norm_apply(cfg.norm, lp["norm1"], x)
        if cfg.mixer_kind(i) == "attn":
            h, (k, v) = A.attn_prefill(lp["attn"], h, cfg, positions)
            lc["k"][:, :S] = k.to(cdt)
            lc["v"][:, :S] = v.to(cdt)
        else:
            h, (conv, _) = M.mamba_apply(lp["mamba"], h, cfg,
                                         ssm_state=lc["ssm"])
            lc["conv"].copy_(conv)
        x = _channel(lp, x + h, cfg, i)
        cache.append(lc)
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    logits = linear(params["head"], x)[:, 0, :]
    return logits, cache


def apply_decode(params, cfg, cache, batch, pos: int):
    """One decode step. batch: tokens (B, 1) | embeds (B, 1, d); pos: int.

    Returns (logits (B, V), cache); the cache tensors are updated in place.
    """
    x = embed_inputs(params, cfg, batch)
    pos = int(pos)
    new = []
    for i, (lp, lc) in enumerate(zip(params["layers"], cache)):
        x, lc = layer_decode(lp, lc, x, cfg, i, pos)
        new.append(lc)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    logits = linear(params["head"], x)[:, 0, :]
    return logits, new


__all__ = ["apply_decode", "apply_prefill", "embed_inputs", "init_cache",
           "init_params", "layer_cache_init", "layer_decode", "layer_init"]
