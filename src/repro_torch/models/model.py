"""Model assembly: the JAX package's ``models/model.py`` as plain
functions over a dict of tensors.

Entry points:
  - ``init_params(gen, cfg, device=None)``          parameters for the model
  - ``apply_train(params, cfg, batch)``              -> (loss, metrics)
  - ``apply_prefill(params, cfg, batch, max_len)``   -> (logits_last, cache)
  - ``apply_decode(params, cfg, cache, batch, pos)`` -> (logits, cache)
  - ``init_cache(cfg, B, max_len, dtype, device)``   decode-state list

Layer structure as in the JAX package: a pre-norm mixer (attention,
Mamba or RWKV time mix) with residual, then a pre-norm channel (MLP, MoE or
RWKV channel mix) with residual, each layer's kinds from
``cfg.mixer_kind(i)`` / ``cfg.channel_kind(i)``; dense, MoE (Granite),
hybrid (Jamba) and RWKV-6 stacks all run.  Differences that change no
result:
  - layers are always a list; the JAX package stacks homogeneous layers for
    ``lax.scan`` (:func:`repro_torch.convert.model_params_from_numpy` takes
    either layout);
  - ``repro.parallel.ctx.constrain_acts`` is a no-op on one device and is
    dropped;
  - ``apply_prefill`` and ``apply_decode`` write the caches in place and
    return them: the KV cache rows, the conv state and the SSM state, the
    RWKV (hd, hd) state (each scan kernel writes its final state where it
    read the carried one) and the RWKV blocks' last tokens;
  - ``remat="full"`` is ``torch.utils.checkpoint`` per layer (the JAX
    package's ``jax.checkpoint``); no config uses ``"dots"``, which raises.
Training runs every layer kind.  Its forward goes through the same kernels
as serving: the MoE's expert matmuls (three a MoE layer, each with a
``torch.bmm`` backward), and the Mamba and RWKV scans once a
``cfg.mamba_chunk`` / ``cfg.rwkv_chunk``-step segment, each segment
recomputed by the plain scan in the backward; with ``remat="full"`` the
layer's forward runs again in the backward, and its launches with it.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch.parallel.sharding import gather

from . import attention as A
from . import mamba as M
from . import moe as X
from . import rwkv6 as R
from .layers import (chunked_softmax_xent, embed, embed_init, linear,
                     linear_init, mlp, mlp_init, norm_apply, norm_init)

Params = Any

#: config dtype names -> torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _generator(gen, device) -> torch.Generator:
    """An int seeds a new generator on ``device`` (so a large model is drawn
    where it lives); a ``torch.Generator`` is used as given."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


# ================================================================= layers ====
def layer_init(gen, cfg, i: int, dtype, device=None):
    kw = dict(dtype=dtype, device=device)
    mix, ch = cfg.mixer_kind(i), cfg.channel_kind(i)
    p = {"norm1": norm_init(cfg.norm, cfg.d_model, **kw),
         "norm2": norm_init(cfg.norm, cfg.d_model, **kw)}
    if mix == "attn":
        p["attn"] = A.attn_init(gen, cfg, **kw)
    elif mix == "mamba":
        p["mamba"] = M.mamba_init(gen, cfg, **kw)
    else:
        p["rwkv_tm"] = R.timemix_init(gen, cfg, **kw)
    if ch == "mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)
    elif ch == "moe":
        p["moe"] = X.moe_init(gen, cfg, **kw)
    else:
        p["rwkv_cm"] = R.channelmix_init(gen, cfg, **kw)
    return p


def layer_apply(p, x, cfg, i: int, positions):
    """Full-sequence layer for training.  Returns (x, aux_loss); the aux
    loss is the MoE router's (0 for other channels)."""
    mix, ch = cfg.mixer_kind(i), cfg.channel_kind(i)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(cfg.norm, p["norm1"], x)
    if mix == "attn":
        h = A.attn_train(p["attn"], h, cfg, positions)
    elif mix == "mamba":
        h, _ = M.mamba_apply(p["mamba"], h, cfg)
    else:
        h, _ = R.timemix_apply(p["rwkv_tm"], h, cfg)
    x = x + h
    h = norm_apply(cfg.norm, p["norm2"], x)
    if ch == "mlp":
        h = mlp(p["mlp"], h, cfg.mlp_kind)
    elif ch == "moe":
        h, aux = X.moe_apply(p["moe"], h, cfg)
    else:
        h, _ = R.channelmix_apply(p["rwkv_cm"], h, cfg)
    return x + h, aux


def layer_cache_init(cfg, i: int, B: int, max_len: int, dtype, device=None):
    mix = cfg.mixer_kind(i)
    if mix == "attn":
        shape = (B, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mix == "mamba":
        di = cfg.mamba_expand * cfg.d_model
        return {"conv": torch.zeros((B, cfg.mamba_d_conv - 1, di),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((B, di, cfg.mamba_d_state),
                                   dtype=torch.float32, device=device)}
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_size      # max_len is not used
    return {"x_tm": torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
            "x_cm": torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
            "wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                               device=device)}


def _channel(p, x, cfg, i: int, cache):
    """The channel half of layer i; the RWKV channel mix reads the previous
    token from ``cache["x_cm"]`` (zero after ``layer_cache_init``) and
    writes its input's last token there."""
    h = norm_apply(cfg.norm, p["norm2"], x)
    ch = cfg.channel_kind(i)
    if ch == "mlp":
        return x + mlp(p["mlp"], h, cfg.mlp_kind)
    if ch == "moe":
        h, _ = X.moe_apply(p["moe"], h, cfg)
        return x + h
    h, x_last = R.channelmix_apply(p["rwkv_cm"], h, cfg, cache["x_cm"])
    cache["x_cm"].copy_(x_last)
    return x + h


def layer_decode(p, cache, x, cfg, i: int, pos: int):
    """Single-token step. x: (B, 1, d); pos: int. -> (x, cache), the
    cache's tensors updated in place."""
    h = norm_apply(cfg.norm, p["norm1"], x)
    mix = cfg.mixer_kind(i)
    if mix == "attn":
        h, _, _ = A.attn_decode(p["attn"], h, cfg, cache["k"], cache["v"],
                                pos)
    elif mix == "mamba":
        h, (conv, _) = M.mamba_apply(p["mamba"], h, cfg, cache["conv"],
                                     cache["ssm"])
        cache["conv"].copy_(conv)
    else:
        h, (x_last, _) = R.timemix_apply(p["rwkv_tm"], h, cfg, cache["x_tm"],
                                         cache["wkv"])
        cache["x_tm"].copy_(x_last)
    return _channel(p, x + h, cfg, i, cache), cache


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


def _remat(fn, cfg):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise NotImplementedError(f"remat={cfg.remat!r} is not ported (no "
                              "config uses it)")


def _outer(params):
    """``params`` with everything but the layers gathered (each layer is
    gathered as it runs)."""
    return {k: v if k == "layers" else gather(v) for k, v in params.items()}


def forward_hidden(params, cfg, batch):
    """Runs the full stack; returns (hidden (B, S, d), aux_loss)."""
    params = _outer(params)
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        def one(xx, lp, i=i):
            return layer_apply(gather(lp), xx, cfg, i, positions)
        x, a = _remat(one, cfg)(x, lp)
        aux = aux + a
    return x, aux


def apply_train(params, cfg, batch):
    """batch: tokens|embeds, labels (B, S) int (-100 = masked) ->
    (loss, {"xent", "aux", "loss"})."""
    params = _outer(params)
    x, aux = forward_hidden(params, cfg, batch)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    xent = chunked_softmax_xent(x, params["head"]["w"], batch["labels"],
                                chunk=cfg.loss_chunk)
    loss = xent + aux
    return loss, {"xent": xent, "aux": aux, "loss": loss}


def dummy_batch(cfg, B: int, S: int, kind: str = "train", gen=None,
                device=None):
    """A concrete small batch for smoke tests, drawn from ``gen`` (a
    ``torch.Generator`` or an int seed; default seed 0)."""
    dev = _device.resolve(device)
    gen = _generator(0 if gen is None else gen, dev)
    b: dict = {}
    if cfg.frontend == "tokens":
        b["tokens"] = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=gen.device,
                                    dtype=torch.int32).to(dev)
    else:
        b["embeds"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                  device=gen.device).mul_(0.02).to(dev)
    if kind == "train":
        b["labels"] = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=gen.device,
                                    dtype=torch.int32).to(dev)
    return b


def init_cache(cfg, B: int, max_len: int, dtype=torch.bfloat16, device=None):
    return [layer_cache_init(cfg, i, B, max_len, dtype, device)
            for i in range(cfg.n_layers)]


def apply_prefill(params, cfg, batch, max_len: int | None = None):
    """Processes the prompt; returns (logits_last (B, V), cache at len S).

    The returned attention caches have length ``max_len`` (default S) so
    decode can write in place; S > ``max_len`` raises, as the JAX package's
    cache update fails there.
    """
    params = _outer(params)
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
        lp = gather(lp)
        lc = layer_cache_init(cfg, i, B, max_len, cdt, x.device)
        h = norm_apply(cfg.norm, lp["norm1"], x)
        mix = cfg.mixer_kind(i)
        if mix == "attn":
            h, (k, v) = A.attn_prefill(lp["attn"], h, cfg, positions)
            lc["k"][:, :S] = k.to(cdt)
            lc["v"][:, :S] = v.to(cdt)
        elif mix == "mamba":
            h, (conv, _) = M.mamba_apply(lp["mamba"], h, cfg,
                                         ssm_state=lc["ssm"])
            lc["conv"].copy_(conv)
        else:
            h, (x_last, _) = R.timemix_apply(lp["rwkv_tm"], h, cfg,
                                             state=lc["wkv"])
            lc["x_tm"].copy_(x_last)
        x = _channel(lp, x + h, cfg, i, lc)
        cache.append(lc)
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    logits = linear(params["head"], x)[:, 0, :]
    return logits, cache


def apply_decode(params, cfg, cache, batch, pos: int):
    """One decode step. batch: tokens (B, 1) | embeds (B, 1, d); pos: int.

    Returns (logits (B, V), cache); the cache tensors are updated in place.
    """
    params = _outer(params)
    x = embed_inputs(params, cfg, batch)
    pos = int(pos)
    new = []
    for i, (lp, lc) in enumerate(zip(params["layers"], cache)):
        x, lc = layer_decode(gather(lp), lc, x, cfg, i, pos)
        new.append(lc)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    logits = linear(params["head"], x)[:, 0, :]
    return logits, new


__all__ = ["apply_decode", "apply_prefill", "apply_train", "dummy_batch",
           "embed_inputs", "forward_hidden", "init_cache", "init_params",
           "layer_apply", "layer_cache_init", "layer_decode", "layer_init"]
