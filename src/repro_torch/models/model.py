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
  - ``repro.parallel.ctx.constrain_acts`` is not called: its "seq" and
    "dmodel" modes are hints to GSPMD, and the port's layer-boundary
    activations stay replicated over "model" (no sequence parallelism);
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

Under a mesh (``Trainer(mesh=...)``, the dry run, the sharded serve
steps) the params are DTensors.  Where ``parallel.ctx`` has a "model" axis
wider than 1 (train and prefill of the configs whose rule tables shard
over "model": qwen2.5-32b, grok-1-314b, jamba-v0.1-52b; decode of every
config, on the decode rule table), each step gathers each weight over the
batch axes only (``sharding.gather_local``, which names the weights it
left split, from their placements) and every module whose weights stay
split over "model" runs its tensor-parallel form (Megatron-style column /
row pairs: ``layers.embed`` / ``mlp`` / ``chunked_softmax_xent``,
``attention``, ``moe``, ``mamba``, ``rwkv6``), each rank on its own
heads, channels and experts; a module whose weights the rule table left
whole runs as on one device on every rank.  Otherwise (``fsdp_only``
training, a 1-wide "model" axis) each layer gathers its weights whole
(``sharding.gather``) and every rank computes on them.  The serve steps
read placed batches and caches as this rank's shards (``sharding.local``,
``sharding.seq_split``): a decode attends over the rank's positions of a
sequence-split KV cache, and an ``fsdp_only`` prefill whose batch's
sequence is split over "model" runs each rank on its own block of
positions; neither gathers a sequence or a cache whole.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import (gather, gather_local, local,
                                            seq_split)

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


def layer_apply(p, x, cfg, i: int, positions, tp=frozenset()):
    """Full-sequence layer for training.  Returns (x, aux_loss); the aux
    loss is the MoE router's (0 for other channels).  ``tp``: the modules
    whose weights in ``p`` are this rank's shards over "model" (their
    tensor-parallel forms run)."""
    mix, ch = cfg.mixer_kind(i), cfg.channel_kind(i)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(cfg.norm, p["norm1"], x)
    if mix == "attn":
        h = A.attn_train(p["attn"], h, cfg, positions, "attn" in tp)
    elif mix == "mamba":
        h, _ = M.mamba_apply(p["mamba"], h, cfg, tp="mamba" in tp)
    else:
        h, _ = R.timemix_apply(p["rwkv_tm"], h, cfg)
    x = x + h
    h = norm_apply(cfg.norm, p["norm2"], x)
    if ch == "mlp":
        h = mlp(p["mlp"], h, cfg.mlp_kind, "mlp" in tp)
    elif ch == "moe":
        h, aux = X.moe_apply(p["moe"], h, cfg, "moe" in tp)
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


def _channel(p, x, cfg, i: int, cache, tp=frozenset(), split=None):
    """The channel half of layer i; the RWKV channel mix reads the previous
    token from ``cache["x_cm"]`` (zero after ``layer_cache_init``) and
    writes its input's last token there.  With a sequence ``split`` of more
    than one rank (a split prefill, from zero) x is this rank's block: the
    RWKV mix's first previous token is the rank before's, and the last
    token written is the sequence's."""
    h = norm_apply(cfg.norm, p["norm2"], x)
    ch = cfg.channel_kind(i)
    if ch == "mlp":
        return x + mlp(p["mlp"], h, cfg.mlp_kind, "mlp" in tp)
    if ch == "moe":
        h, _ = X.moe_apply(p["moe"], h, cfg, "moe" in tp, split)
        return x + h
    if split is not None and split.n > 1:
        h, x_last = R.channelmix_apply(p["rwkv_cm"], h, cfg, split=split)
        cache["x_cm"].copy_(pctx.seq_last(x_last, split))
        return x + h
    h, x_last = R.channelmix_apply(p["rwkv_cm"], h, cfg, cache["x_cm"],
                                   "rwkv_cm" in tp)
    cache["x_cm"].copy_(x_last)
    return x + h


def layer_decode(p, cache, x, cfg, i: int, pos: int, tp=frozenset(),
                 split=None):
    """Single-token step. x: (B, 1, d); pos: int. -> (x, cache), the
    cache's tensors updated in place.  ``tp``: the modules whose weights in
    ``p`` are this rank's shards over "model" (their tensor-parallel forms
    run, on the cache's shards of their states); ``split``: the
    :class:`~repro_torch.parallel.sharding.SeqSplit` of an attention
    layer's KV cache, whose positions this rank holds."""
    h = norm_apply(cfg.norm, p["norm1"], x)
    mix = cfg.mixer_kind(i)
    if mix == "attn":
        h, _, _ = A.attn_decode(p["attn"], h, cfg, cache["k"], cache["v"],
                                pos, "attn" in tp, split)
    elif mix == "mamba":
        h, (conv, _) = M.mamba_apply(p["mamba"], h, cfg, cache["conv"],
                                     cache["ssm"], tp="mamba" in tp)
        cache["conv"].copy_(conv)
    else:
        h, (x_last, _) = R.timemix_apply(p["rwkv_tm"], h, cfg, cache["x_tm"],
                                         cache["wkv"], "rwkv_tm" in tp)
        cache["x_tm"].copy_(x_last)
    return _channel(p, x + h, cfg, i, cache, tp), cache


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


def _positions(cfg, batch, B, S, device, offset: int = 0):
    """The batch's positions, or ``offset + arange(S)`` (M-RoPE's text
    default: t = h = w = that index)."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(offset, offset + S, dtype=torch.int32,
                       device=device)[None, :]
    pos = pos.expand(B, S)
    if cfg.mrope_sections:  # text default: t = h = w = linear index
        pos = pos[None].expand(3, B, S)
    return pos


def embed_inputs(params, cfg, batch, tp: bool = False):
    """Token ids or precomputed frontend embeddings -> (B, S, d) activations
    in the compute dtype; ``tp``: the embedding table is this rank's vocab
    rows."""
    cdt = DTYPES[cfg.compute_dtype]
    if cfg.frontend == "tokens":
        return embed(params["embed"], batch["tokens"], tp).to(cdt)
    return norm_apply(cfg.norm, params["in_norm"], batch["embeds"].to(cdt))


def _remat(fn, cfg):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise NotImplementedError(f"remat={cfg.remat!r} is not ported (no "
                              "config uses it)")


def _gather(tree, tp: bool = True):
    """(``tree`` gathered, the top-level keys of its modules whose weights
    stay this rank's shards over "model", which run their tensor-parallel
    forms).  Over the batch axes only where ``tp`` and the policy has a
    "model" axis wider than 1 (``sharding.gather_local`` reads the split
    from the placements), whole otherwise."""
    if tp and pctx.tp_size() > 1:
        tree, split = gather_local(tree)
        return tree, frozenset(path[0] for path in split)
    return gather(tree), frozenset()


def _outer(params, tp: bool = True):
    """``params`` with everything but the layers gathered by :func:`_gather`
    (each layer is gathered as it runs), and its split keys."""
    outer, split = _gather({k: v for k, v in params.items()
                            if k != "layers"}, tp)
    return {k: outer.get(k, v) for k, v in params.items()}, split


def _hidden(params, tp, cfg, batch):
    """:func:`forward_hidden` on ``_outer``'s result."""
    x = embed_inputs(params, cfg, batch, "embed" in tp)
    B, S, _ = x.shape
    positions = _positions(cfg, batch, B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        def one(xx, lp, i=i):
            lp, ltp = _gather(lp)
            return layer_apply(lp, xx, cfg, i, positions, ltp)
        x, a = _remat(one, cfg)(x, lp)
        aux = aux + a
    return x, aux


def forward_hidden(params, cfg, batch):
    """Runs the full stack; returns (hidden (B, S, d), aux_loss)."""
    return _hidden(*_outer(params), cfg, batch)


def apply_train(params, cfg, batch):
    """batch: tokens|embeds, labels (B, S) int (-100 = masked) ->
    (loss, {"xent", "aux", "loss"})."""
    params, tp = _outer(params)
    x, aux = _hidden(params, tp, cfg, batch)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    xent = chunked_softmax_xent(x, params["head"]["w"], batch["labels"],
                                chunk=cfg.loss_chunk, tp="head" in tp)
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


def _local_batch(batch):
    """(the batch's leaves as this rank's plain shards, the
    :class:`~repro_torch.parallel.sharding.SeqSplit` of its sequence: the
    ``tokens`` or ``embeds`` leaf's dim 1)."""
    key = "tokens" if "tokens" in batch else "embeds"
    split = seq_split(batch[key], 1)
    return {k: local(v) for k, v in batch.items()}, split


def apply_prefill(params, cfg, batch, max_len: int | None = None):
    """Processes the prompt; returns (logits_last (B, V), cache at len S).

    The returned attention caches have length ``max_len`` (default S) so
    decode can write in place; S > ``max_len`` raises, as the JAX package's
    cache update fails there.

    A batch placed with its sequence split over ranks
    (``batch_specs(..., seq_over_model=True)``, the ``fsdp_only`` configs'
    prefill under a mesh, weights replicated) runs split: this rank's
    block of positions through every layer (attention over the blocks up
    to its own, the RWKV scan carried across the ranks, the MoE's capacity
    the whole row's), and the last token's logits from the last rank on
    every rank.  The cache leaves the step split as placed: each attention
    cache holds this rank's rows of its positions (``max_len`` must be S),
    and the RWKV states and last tokens the sequence's end on every rank.
    """
    batch, split = _local_batch(batch)
    params, outer_tp = _outer(params)
    x = embed_inputs(params, cfg, batch, "embed" in outer_tp)
    B, S, _ = x.shape
    if split.n > 1:
        if not cfg.fsdp_only:
            raise ValueError(f"{cfg.name}: a sequence-split prefill is the "
                             "fsdp_only configs' (replicated weights)")
        if (max_len or split.length) != split.length:
            raise ValueError("a sequence-split prefill's cache is the "
                             f"prompt's {split.length} positions, not "
                             f"max_len={max_len}")
        max_len = S
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds the cache length "
                         f"max_len={max_len}")
    positions = _positions(cfg, batch, B, S, x.device, split.lo)
    cdt = x.dtype
    cache = []
    for i, lp in enumerate(params["layers"]):
        lp, tp = _gather(lp)
        if split.n > 1 and tp:
            raise ValueError(f"a sequence-split prefill with weights split "
                             f"over 'model': {sorted(tp)}")
        lc = layer_cache_init(cfg, i, B, max_len, cdt, x.device)
        h = norm_apply(cfg.norm, lp["norm1"], x)
        mix = cfg.mixer_kind(i)
        if mix == "attn":
            h, (k, v) = A.attn_prefill(lp["attn"], h, cfg, positions,
                                       "attn" in tp, split)
            lc["k"][:, :S] = k.to(cdt)
            lc["v"][:, :S] = v.to(cdt)
        elif mix == "mamba" and split.n > 1:
            raise ValueError("no sequence-split Mamba prefill (no "
                             "fsdp_only config has Mamba)")
        elif mix == "mamba" and "mamba" in tp:   # the rank's channels
            n = pctx.tp_size()
            ssm = lc["ssm"].chunk(n, 1)[pctx.tp_rank()].clone()
            h, (conv, _) = M.mamba_apply(lp["mamba"], h, cfg,
                                         ssm_state=ssm, tp=True)
            lc["conv"].copy_(pctx.gather_tp(conv, -1))
            lc["ssm"].copy_(pctx.gather_tp(ssm, 1))
        elif mix == "mamba":
            h, (conv, _) = M.mamba_apply(lp["mamba"], h, cfg,
                                         ssm_state=lc["ssm"])
            lc["conv"].copy_(conv)
        else:
            h, (x_last, st) = R.timemix_apply(lp["rwkv_tm"], h, cfg,
                                              state=lc["wkv"], split=split)
            lc["x_tm"].copy_(pctx.seq_last(x_last, split))
            lc["wkv"].copy_(pctx.seq_last(st, split))
        x = _channel(lp, x + h, cfg, i, lc, tp, split)
        cache.append(lc)
    x = norm_apply(cfg.norm, params["final_norm"],
                   pctx.seq_last(x[:, -1:, :], split))
    logits = linear(params["head"], x)[:, 0, :]
    if "head" in outer_tp:                       # the ranks' vocab columns
        logits = pctx.gather_tp(logits, -1)
    return logits, cache


def apply_decode(params, cfg, cache, batch, pos: int):
    """One decode step. batch: tokens (B, 1) | embeds (B, 1, d); pos: int.

    Returns (logits (B, V), cache); the cache tensors are updated in place.
    Under a mesh the params, the cache and the batch are placed
    (``shard_params(mode="decode")``, ``shard_cache``, ``batch_specs``):
    each layer's weights are gathered over the batch axes only and its
    modules split over "model" run their tensor-parallel forms on the
    cache's shards of their states; each attention layer reads the
    positions of its KV cache this rank holds (``sharding.seq_split``);
    nothing is gathered whole.  The batch is this rank's rows and so are
    the logits.
    """
    batch, _ = _local_batch(batch)
    params, outer_tp = _outer(params)
    x = embed_inputs(params, cfg, batch, "embed" in outer_tp)
    pos = int(pos)
    for i, (lp, lc) in enumerate(zip(params["layers"], cache)):
        lp, tp = _gather(lp)
        split = seq_split(lc["k"], 1) if "k" in lc else None
        x, _ = layer_decode(lp, {k: local(v) for k, v in lc.items()}, x,
                            cfg, i, pos, tp, split)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    logits = linear(params["head"], x)[:, 0, :]
    if "head" in outer_tp:
        logits = pctx.gather_tp(logits, -1)
    return logits, cache


__all__ = ["apply_decode", "apply_prefill", "apply_train", "dummy_batch",
           "embed_inputs", "forward_hidden", "init_cache", "init_params",
           "layer_apply", "layer_cache_init", "layer_decode", "layer_init"]
