"""The plain reference of the benchmark's model layers.

RMS-normed pre-norm layers, each grouped-query attention with rotary
positions followed by top-k routed SwiGLU experts with a capacity per
expert, as the configuration files under ``bench/configs/`` state them,
with each place where the measured program departs from the published
model listed there under ``assumed``.  Written from those equations in
plain PyTorch, computing in float32 with TF32 off (or in ``cdt``, for a
control run in a lower precision), with no kernel, cache or batching of
the program.

Weights come in as a mapping from the benchmark's leaf names
(``layers.3.moe.gate``) to tensors.  Imports nothing but ``torch``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = float("-inf")


def exact_f32() -> None:
    """float32 matrix products in full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """How the reference computes: ``cdt`` the type of every matrix
    product's operands (float32, or bfloat16 for a control)."""

    def __init__(self, cdt=torch.float32):
        self.cdt = cdt

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x.to(self.cdt) @ w.to(self.cdt)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.cdt)


F32 = Precision()


def rmsnorm(x, g, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """x (..., T, H, hd): the two halves of each head rotated as pairs."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = positions.float()[:, None] * inv                # (T, hd / 2)
    sin, cos = ang.sin()[:, None, :], ang.cos()[:, None, :]
    a, b = x.float().chunk(2, -1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1).to(x.dtype)


def attention(w: dict, x, hf: dict, pr: Precision = F32, block: int = 1024):
    """Causal GQA over one sequence x (T, d), queries in blocks."""
    T, _ = x.shape
    H, Kv = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd = hf.get("head_dim") or hf["hidden_size"] // H
    G = H // Kv
    pos = torch.arange(T, device=x.device)
    q = rope(pr.mm(x, w["wq.w"]).view(T, H, hd), pos, hf["rope_theta"])
    k = rope(pr.mm(x, w["wk.w"]).view(T, Kv, hd), pos, hf["rope_theta"])
    v = pr.mm(x, w["wv.w"]).view(T, Kv, hd)
    out = torch.empty((T, H, hd), dtype=q.dtype, device=x.device)
    kk = k.permute(1, 0, 2).float()                       # (Kv, T, hd)
    vv = v.permute(1, 0, 2).float()
    for a in range(0, T, block):
        b = min(a + block, T)
        qb = q[a:b].float().view(b - a, Kv, G, hd).permute(1, 2, 0, 3)
        s = qb @ kk[:, None, :b].transpose(-1, -2) * hd ** -0.5
        mask = torch.arange(a, b, device=x.device)[:, None] >= \
            torch.arange(b, device=x.device)[None, :]
        s = s.masked_fill(~mask, NEG)
        o = torch.softmax(s, -1) @ vv[:, None, :b]        # (Kv, G, n, hd)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, hd).to(q.dtype)
    return pr.mm(out.reshape(T, H * hd), w["wo.w"])


def capacity(tokens: int, k: int, E: int, factor: float) -> int:
    """Slots an expert takes for a group of ``tokens``: the top-k share
    times the capacity factor, at least k, a multiple of 8 from 8 on."""
    c = max(k, int(math.ceil(tokens * k * factor / E)))
    return -(-c // 8) * 8 if c >= 8 else c


def route(w: dict, x, k: int):
    """Router in float32: softmax over the experts, the top k (the lower
    expert first among equals), gates renormalised over them.  Returns
    (logits, probs, gates (T, k), idx (T, k))."""
    logits = x.float() @ w["router.w"].float()
    probs = torch.softmax(logits, -1)
    g, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    g, idx = g[..., :k], idx[..., :k]
    return logits, probs, g / g.sum(-1, keepdim=True).clamp(min=1e-9), idx


def kept(idx, E: int, C: int):
    """(T, k) mask of the routed entries an expert keeps: in the order of
    the tokens, then of each token's k choices, the first C of each."""
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, E)
    rank = onehot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1
    return (rank < C).view(idx.shape)


def moe(w: dict, x, hf: dict, pr: Precision = F32):
    """Routed experts over one training row x (T, d), one capacity
    group.  Returns (y, logits, probs, idx) for the router's losses."""
    E, k = w["gate"].shape[0], hf["num_experts_per_tok"]
    logits, probs, gates, idx = route(w, x, k)
    keep = kept(idx, E, capacity(x.shape[0], k, E, hf["moe_capacity_factor"]))
    y = torch.zeros_like(pr.act(x))
    for e in range(E):
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        xe = x[t]
        o = pr.mm(F.silu(pr.mm(xe, w["gate"][e])) * pr.mm(xe, w["up"][e]),
                  w["down"][e])
        y = y.index_add(0, t, o * pr.act(gates[t, j, None]))
    return y, logits, probs, idx


def sub(w: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` with it taken off their names."""
    n = len(prefix)
    return {k[n:]: v for k, v in w.items() if k.startswith(prefix)}


__all__ = ["F32", "Precision", "attention", "capacity", "exact_f32", "kept",
           "moe", "rmsnorm", "route", "sub"]
