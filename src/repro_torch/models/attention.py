"""Grouped-query attention: the JAX package's ``models/attention.py``.

Entry points per layer:
  - ``attn_train``   : full-sequence causal attention with a gradient
                       (:class:`FlashAttention`): the forward through the
                       hand-written CUDA kernel on the card
                       (:mod:`repro_torch.kernels.flash_attention`, which
                       also writes the rows' log-sum-exp) and its plain
                       version on the CPU; the backward is the JAX model's
                       blockwise ``_fa_bwd`` in PyTorch
  - ``attn_prefill`` : the same forward, also returning the layer's K/V
  - ``attn_decode``  : one new token against a (possibly longer) KV cache,
                       plain PyTorch as in the JAX package, which computes
                       it outside any Pallas kernel

The JAX package's ``causal_attention`` pads S to a block multiple for its
XLA fallback; the CUDA kernel masks the ragged edge of S itself, and the
backward slices a ragged last query block, so nothing pads here.

Tensor parallelism (``tp=True`` in ``attn_train`` / ``attn_prefill``: the
weights are this rank's shards over "model"): each rank projects its own
columns of ``wq`` / ``wk`` / ``wv`` (and of qwen's bias), which need not
hold whole heads (qwen2.5-32b's 40 heads over 16 ranks are 2.5 a rank,
and 8 KV heads are half a head a rank).  :func:`head_split` gives rank r
the q heads ``[r H // n, (r + 1) H // n)`` and the KV heads they read; one
all-to-all each forms the rank's whole q heads and sends each KV head to
every rank whose q heads read it (``parallel.ctx.exchange``).  RoPE and
qk-norm run on whole heads (the replicated norm weights' gradients summed
over the ranks), the kernel on the rank's heads, and one more
all-to-all returns its output to column shards for the row-parallel
``wo``, whose partial sums are added over the ranks.  Where the heads
divide over the ranks as the columns do, every exchange is the identity
and sends nothing.  A rank whose heads straddle a KV group boundary
without covering whole groups reads its KV heads repeated once per q head
(G = 1); no config's split does.  A prefill gathers the ranks' K / V
columns instead (it returns the whole cache) and takes its heads from
them.  A decode step gathers the new token's q, k and v columns whole
(B x (H + 2 Kv) x hd values) and attends with every head; only ``wo`` is
split (its rows), so no head exchange is needed for any head count.

Sequence splits (``split``, a :class:`~repro_torch.parallel.sharding.
SeqSplit` of more than one rank): an ``fsdp_only`` prefill runs rank r's
block of queries over the K / V blocks 0..r, gathered, with one kernel
launch a block (:func:`_split_prefill`); a decode step writes the new K /
V on the rank holding ``pos`` and attends over each rank's positions of
the cache, the softmax combined over the ranks so that the JAX package's
rounding of the normalised probabilities holds (:func:`decode_attention`).
"""
from __future__ import annotations

import torch

from repro_torch._tree import map_tree
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import SeqSplit

from .layers import (apply_mrope, apply_rope, linear, linear_init, rmsnorm,
                     rmsnorm_init)

NEG_INF = -1e30


def attn_init(gen, cfg, dtype=torch.float32, device=None):
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": linear_init(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, d, Kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, d, Kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, H * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, **kw)
        p["k_norm"] = rmsnorm_init(hd, **kw)
    return p


def _project_qkv(p, x, cfg, positions):
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, Kv, hd), contiguous;
    qk-norm (where the config has it) comes before RoPE."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, H, hd)
    k = linear(p["wk"], x).reshape(B, S, Kv, hd)
    v = linear(p["wv"], x).reshape(B, S, Kv, hd)
    q, k = _rotate(q, k, p, cfg, positions)
    return q, k, v.contiguous()


def _rotate(q, k, p, cfg, positions):
    """qk-norm (where the config has it), then RoPE, on whole heads."""
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.mrope_sections:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def head_split(H: int, Kv: int, n: int, r: int) -> tuple[int, int, int, int]:
    """Rank ``r`` of ``n``'s q heads [a, b) (a balanced contiguous split)
    and the KV heads [ka, kb) they read."""
    if H < n:
        raise ValueError(f"{H} heads over {n} tensor-parallel ranks")
    G = H // Kv
    a, b = r * H // n, (r + 1) * H // n
    return a, b, a // G, (b - 1) // G + 1


def _kv_rows(a: int, b: int, ka: int, kb: int, G: int):
    """The local KV head each local q head reads, where the rank's heads
    do not map onto its KV heads in groups of one size (None where they
    do: whole groups, or one KV head)."""
    if kb - ka == 1 or (a % G == 0 and b % G == 0):
        return None
    return [(a + i) // G - ka for i in range(b - a)]


def _project_qkv_tp(p, x, cfg, positions, whole_kv: bool = False):
    """This rank's q heads and the KV heads they read, from its column
    shards of the projections; with ``whole_kv`` also every KV head (the
    ranks' columns gathered), for a prefill's cache."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n, r = pctx.tp_size(), pctx.tp_rank()
    split = [head_split(H, Kv, n, s) for s in range(n)]
    a, b, ka, kb = split[r]
    x = pctx.copy_to_tp(x)
    if cfg.qk_norm:     # replicated weights applied to the rank's own heads
        p = {**p, "q_norm": map_tree(pctx.copy_to_tp, p["q_norm"]),
             "k_norm": map_tree(pctx.copy_to_tp, p["k_norm"])}
    q = pctx.exchange(linear(p["wq"], x), pctx.shards(H * hd, n),
                      [[(s[0] * hd, s[1] * hd)] for s in split])
    q = q.reshape(B, S, b - a, hd)
    k, v = linear(p["wk"], x), linear(p["wv"], x)
    if whole_kv:
        k = pctx.gather_tp(k, -1).reshape(B, S, Kv, hd)
        v = pctx.gather_tp(v, -1).reshape(B, S, Kv, hd)
        q, k = _rotate(q, k, p, cfg, positions)
        kv = (k, v)
        k, v = k[:, :, ka:kb], v[:, :, ka:kb]
    else:
        want = [[(s[2] * hd, s[3] * hd)] for s in split]
        k = pctx.exchange(k, pctx.shards(Kv * hd, n), want)
        v = pctx.exchange(v, pctx.shards(Kv * hd, n), want)
        q, k = _rotate(q, k.reshape(B, S, kb - ka, hd), p, cfg, positions)
        v, kv = v.reshape(B, S, kb - ka, hd), None
    rows = _kv_rows(a, b, ka, kb, H // Kv)
    if rows is not None:
        idx = torch.tensor(rows, device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k.contiguous(), v.contiguous(), kv


def _out_tp(p, o, cfg):
    """The local heads' output (B, S, h, hd) back to this rank's column
    shard, through the row-parallel ``wo``, added over the ranks."""
    B, S, _, hd = o.shape
    H, Kv, n = cfg.n_heads, cfg.n_kv_heads, pctx.tp_size()
    have = [head_split(H, Kv, n, s)[:2] for s in range(n)]
    o = pctx.exchange(o.reshape(B, S, -1), [(a * hd, b * hd)
                                           for a, b in have],
                      [[c] for c in pctx.shards(H * hd, n)])
    return pctx.reduce_from_tp(linear(p["wo"], o))


def causal_attention(q, k, v):
    """Causal GQA attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  q (B, S, H, hd); k, v (B, S, Kv, hd)."""
    return flash_attention(q, k, v, causal=True)


def _fa_bwd(q, k, v, out, lse, do, block_q: int):
    """The JAX model's ``_fa_bwd`` (causal): query blocks of ``block_q``
    rows, scores recomputed from the saved log-sum-exp, all in f32 (f64 for
    f64 inputs) whatever the inputs' dtype, the G query heads of each KV
    head summed into its dk and dv.  Keys past a block's last query are
    masked for every row of it (their p is exactly 0), so each block reads
    only the keys up to its end; the JAX package scans all S of them.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    bq = min(block_q, S)
    scale = hd ** -0.5
    wide = torch.promote_types(q.dtype, torch.float32)
    delta = (do.to(wide) * out.to(wide)).sum(-1)            # (B, S, H)
    kw, vw = k.to(wide), v.to(wide)
    dq = torch.empty(q.shape, dtype=wide, device=q.device)
    dk = torch.zeros(k.shape, dtype=wide, device=q.device)
    dv = torch.zeros(v.shape, dtype=wide, device=q.device)
    for i0 in range(0, S, bq):
        i1 = min(i0 + bq, S)
        n = i1 - i0
        qi = q[:, i0:i1].to(wide).reshape(B, n, Kv, G, hd)
        doi = do[:, i0:i1].to(wide).reshape(B, n, Kv, G, hd)
        lsei = lse[:, i0:i1].to(wide).reshape(B, n, Kv, G)
        di = delta[:, i0:i1].reshape(B, n, Kv, G)
        ki, vi = kw[:, :i1], vw[:, :i1]
        s = torch.einsum("bqkgd,btkd->bqkgt", qi, ki) * scale
        q_pos = torch.arange(i0, i1, device=q.device)
        mask = q_pos[:, None] >= torch.arange(i1, device=q.device)[None, :]
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        p = torch.exp(s - lsei[..., None])                  # (B,n,Kv,G,i1)
        dp = torch.einsum("bqkgd,btkd->bqkgt", doi, vi)
        ds = p * (dp - di[..., None]) * scale
        dq[:, i0:i1] = torch.einsum("bqkgt,btkd->bqkgd", ds, ki).reshape(
            B, n, H, hd)
        dk[:, :i1] += torch.einsum("bqkgt,bqkgd->btkd", ds, qi)
        dv[:, :i1] += torch.einsum("bqkgt,bqkgd->btkd", p, doi)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention with the JAX model's residual contract: the
    forward saves (q, k, v, out, lse) and the backward recomputes the
    scores blockwise from them (:func:`_fa_bwd`).  The forward is
    :func:`~repro_torch.kernels.flash_attention.flash_attention` with the
    log-sum-exp: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  The JAX package has no Pallas backward, so this plain
    backward is its counterpart on both devices."""

    @staticmethod
    def forward(ctx, q, k, v, block_q: int):
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block_q = block_q
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa_bwd(q, k, v, out, lse, do, ctx.block_q)
        return dq, dk, dv, None


def attn_train(p, x, cfg, positions, tp: bool = False):
    if tp:
        q, k, v, _ = _project_qkv_tp(p, x, cfg, positions)
        return _out_tp(p, FlashAttention.apply(q, k, v, cfg.attn_block), cfg)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = FlashAttention.apply(q, k, v, cfg.attn_block)
    B, S, _, _ = o.shape
    return linear(p["wo"], o.reshape(B, S, -1))


def attn_prefill(p, x, cfg, positions, tp: bool = False, split=None):
    """-> (y, (k, v)), the layer's K / V for the cache: whole, or with a
    sequence ``split`` (a :class:`~repro_torch.parallel.sharding.SeqSplit`
    of more than one rank) this rank's positions (:func:`_split_prefill`).
    """
    if split is not None and split.n > 1:
        if tp:
            raise ValueError("a sequence-split prefill has no tensor-"
                             "parallel form (its weights are replicated)")
        return _split_prefill(p, x, cfg, positions, split)
    if tp:
        q, k, v, kv = _project_qkv_tp(p, x, cfg, positions, whole_kv=True)
        return _out_tp(p, causal_attention(q, k, v), cfg), kv
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = causal_attention(q, k, v)
    B, S, _, _ = o.shape
    return linear(p["wo"], o.reshape(B, S, -1)), (k, v)


def _split_prefill(p, x, cfg, positions, split):
    """Causal attention of this rank's block of queries (positions [lo, hi)
    of the sequence) over keys [0, hi): the K / V blocks of the sequence
    group gathered, the kernel run once a block at the block's length
    (its own block causal, each earlier one full, each with its rows'
    log-sum-exp), and the partial outputs merged by their LSEs in f32:
    o = sum_i exp(lse_i - lse) o_i, lse = logsumexp_i lse_i."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    kv = pctx.seq_gather(torch.stack([k, v]), split)   # (n, 2, B, s, Kv, hd)
    parts = [flash_attention(q, k, v, causal=True, return_lse=True)]
    parts += [flash_attention(q, kv[j, 0], kv[j, 1], causal=False,
                              return_lse=True) for j in range(split.index)]
    lses = torch.stack([lse for _, lse in parts])       # (r + 1, B, s, H)
    lse = torch.logsumexp(lses, 0)
    o = sum(torch.exp(lses[i] - lse)[..., None] * o_i.float()
            for i, (o_i, _) in enumerate(parts)).to(q.dtype)
    B, S, _, _ = o.shape
    return linear(p["wo"], o.reshape(B, S, -1)), (k, v)


def decode_attention(q, k_cache, v_cache, kv_len: int, split=None):
    """q: (B, 1, H, hd); caches: (B, S_max, Kv, hd), or with a sequence
    ``split`` this rank's positions [lo, hi) of them; kv_len: valid prefix
    length.  Scores and the PV sum in f32; the normalised probabilities are
    rounded to the cache's dtype before the PV product, as in the JAX
    package.  Split, the softmax is combined in three steps that keep that
    rounding: the max and then the sum of exponentials all-reduced over
    the sequence group, each rank's normalised, rounded PV partial summed
    by a third all-reduce."""
    B, Smax, Kv, hd = k_cache.shape
    H = q.shape[2]
    G = H // Kv
    scale = hd ** -0.5
    split = split or SeqSplit(length=Smax)
    qg = q.reshape(B, Kv, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    pos = torch.arange(split.lo, split.lo + Smax, device=q.device)
    s = torch.where(pos[None, None, None, :] < kv_len, s,
                    torch.full_like(s, NEG_INF))
    m = pctx.seq_max(s.amax(-1, keepdim=True), split)
    p = torch.exp(s - m)
    denom = pctx.seq_sum(p.sum(-1, keepdim=True), split)
    pv = (p / denom).to(v_cache.dtype).float()
    o = pctx.seq_sum(torch.einsum("bkgt,btkd->bkgd", pv, v_cache.float()),
                     split)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _project_token_tp(p, x, cfg):
    """The new token's q, k and v (B, 1, H | Kv, hd) from this rank's
    columns of ``wq`` / ``wk`` / ``wv`` (and of the bias): the ranks'
    columns gathered in one all-gather, B x (H + 2 Kv) x hd values, so
    every rank has every head, whatever the heads' split."""
    B = x.shape[0]
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cols = [linear(p[n], x) for n in ("wq", "wk", "wv")]
    widths = [c.shape[-1] for c in cols]
    n = pctx.tp_size()
    if [w * n for w in widths] != [H * hd, Kv * hd, Kv * hd]:
        raise ValueError(f"attention columns {widths} a rank are not the "
                         f"split of {(H * hd, Kv * hd, Kv * hd)} over {n}")
    got = pctx.gather_tp(torch.cat(cols, -1)[None], 0)   # (n, B, 1, sum)
    out, a = [], 0
    for w, heads in zip(widths, (H, Kv, Kv)):
        out.append(got[..., a:a + w].permute(1, 2, 0, 3)
                   .reshape(B, 1, heads, hd))
        a += w
    return out


def attn_decode(p, x, cfg, k_cache, v_cache, pos: int, tp: bool = False,
                split=None):
    """x: (B, 1, d); caches (B, S_max, Kv, hd), or with a sequence
    ``split`` this rank's positions of them; pos: the current position.

    Writes the new token's K/V into the caches **in place** (the JAX
    package returns updated copies and donates the old ones), on the rank
    that holds ``pos`` alone, and returns (y, k_cache, v_cache).  Like
    ``jax.lax.dynamic_update_slice``, the write index is clamped to
    ``S_max - 1``; the mask keeps ``pos + 1`` keys.  With ``tp`` the
    projections are this rank's column shards and ``wo`` its rows: the
    token's q, k, v are gathered whole (:func:`_project_token_tp`),
    qk-norm and RoPE run on every head, attention over the rank's cache
    positions for every head, and the rank's columns of the output enter
    its rows of ``wo``, whose partial sums are added over the ranks.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections:  # text-only decode: all three M-RoPE indices = pos
        positions = positions.expand(3, B, 1)
    if tp:
        q, k, v = _project_token_tp(p, x, cfg)
        q, k = _rotate(q, k, p, cfg, positions)
    else:
        q, k, v = _project_qkv(p, x, cfg, positions)
    split = split or SeqSplit(length=k_cache.shape[1])
    if split.owner(pos) == split.index:
        at = min(max(pos, 0), split.length - 1) - split.lo
        k_cache[:, at] = k[:, 0].to(k_cache.dtype)
        v_cache[:, at] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos + 1, split)
    o = o.reshape(B, 1, -1)
    if tp:
        w = p["wo"]["w"].shape[0]
        r = pctx.tp_rank()
        y = pctx.reduce_from_tp(linear(p["wo"], o[..., r * w:(r + 1) * w]))
    else:
        y = linear(p["wo"], o)
    return y, k_cache, v_cache


__all__ = ["FlashAttention", "NEG_INF", "attn_decode", "attn_init",
           "attn_prefill", "attn_train", "causal_attention",
           "decode_attention", "head_split"]
