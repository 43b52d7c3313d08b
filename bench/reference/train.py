"""The plain reference of the training cell: loss, gradients, int8
error-feedback compression and AdamW, three steps.

The model is :mod:`bench.reference.model`'s, every layer attention and
experts (Granite-MoE's layout), its loss the mean cross-entropy of
every position plus each experts layer's router losses (the
load-balancing term ``E * sum(mean prob * share of top-1 choices)`` and
the z-loss ``mean(logsumexp(logits) ** 2)``, with the configuration's
coefficients).  Each layer is recomputed in the backward
(``torch.utils.checkpoint``) so the float32 model fits beside its
optimizer state.

The optimizer step follows the configuration's ``optimizer`` entry: each
gradient plus its leaf's error-feedback buffer is rounded to int8 with one
scale for the whole tensor (``max |x| / 127``, round half to even, clamp
to 127), the rounding error kept in the buffer; the rounded gradients are
clipped to a global norm; AdamW with bias correction and decoupled weight
decay updates every leaf.  ``param_dtype`` bfloat16 keeps the weights and
moments in bfloat16 (the control one step below the configuration's
float32 master weights).  Imports nothing but ``torch``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import F32, Precision, attention, moe, rmsnorm, sub


def loss_fn(hf: dict, params: dict, tokens, labels, pr: Precision = F32):
    """Mean cross-entropy over every position plus the router losses."""
    eps = hf["rms_norm_eps"]
    B, S = tokens.shape
    x = pr.act(params["embed.table"][tokens.long()])
    aux = torch.zeros((), device=tokens.device)

    def layer(x, i):
        w = sub(params, f"layers.{i}.")
        h = rmsnorm(x, w["norm1.g"], eps)
        att = sub(w, "attn.")
        x = x + torch.stack([attention(att, h[b], hf, pr) for b in range(B)])
        h = rmsnorm(x, w["norm2.g"], eps)
        outs = [moe(sub(w, "moe."), h[b], hf, pr) for b in range(B)]
        logits = torch.cat([o[1] for o in outs])
        probs = torch.cat([o[2] for o in outs])
        top1 = torch.cat([o[3][:, 0] for o in outs])
        E = probs.shape[-1]
        me = probs.mean(0)
        ce = F.one_hot(top1, E).float().mean(0)
        lb = E * (me * ce).sum()
        z = (torch.logsumexp(logits, -1) ** 2).mean()
        a = hf["load_balance_coef"] * lb + hf["router_z_loss_coef"] * z
        return x + torch.stack([o[0] for o in outs]), a

    for i in range(hf["num_hidden_layers"]):
        x, a = checkpoint(layer, x, i, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, params["final_norm.g"], eps)
    logits = pr.mm(x, params["head.w"]).float()
    xent = F.cross_entropy(logits.view(B * S, -1), labels.reshape(-1).long())
    return xent + aux


def int8_round_trip(e):
    """``e`` rounded to int8 with one scale for the whole tensor."""
    ef = e.float()
    scale = ef.abs().amax().clamp(min=1e-12) / 127.0
    return torch.round(ef / scale).clamp(-127, 127) * scale


def train(hf: dict, weights: dict, batches: list, pr: Precision = F32,
          param_dtype=torch.float32) -> dict:
    """Runs ``len(batches)`` steps from ``weights`` (float32 leaves by
    name).  Returns the steps' losses, each leaf's norm of the first
    gradient as AdamW takes it (compressed and clipped), of its raw first
    gradient, and of its change over all the steps."""
    opt = hf["optimizer"]
    lr, b1, b2 = opt["lr"], opt["b1"], opt["b2"]
    eps_, wd, clip = opt["eps"], opt["weight_decay"], opt["clip_norm"]
    names = list(weights)
    params = {n: weights[n].to(param_dtype).clone().requires_grad_(True)
              for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    ef = {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
    out: dict = {"loss": []}
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss = loss_fn(hf, params, tokens, labels, pr)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            sent = {}
            for n, g in zip(names, grads):
                ef[n] += g.float()
                sent[n] = int8_round_trip(ef[n])
                ef[n] -= sent[n]
            gnorm = torch.sqrt(sum(s.pow(2).sum() for s in sent.values()))
            scale = torch.clamp(clip / gnorm.clamp(min=1e-12), max=1.0)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for n in names:
                g = sent[n] * scale
                m32 = m[n].float().mul_(b1).add_(g, alpha=1 - b1)
                v32 = v[n].float().mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m32 / c1) / ((v32 / c2).sqrt() + eps_)
                p32 = params[n].float()
                p32 -= lr * (upd + wd * p32)
                m[n].copy_(m32)
                v[n].copy_(v32)
                params[n].copy_(p32)
            if step == 1:
                out["grad_raw"] = {n: float(g.float().norm())
                                   for n, g in zip(names, grads)}
                out["grad"] = {n: float(m[n].float().norm()) / (1 - b1)
                               for n in names}
        del grads, sent
    with torch.no_grad():
        out["change"] = {n: float((params[n].float() - weights[n].float())
                                  .norm()) for n in names}
    return out


__all__ = ["int8_round_trip", "loss_fn", "train"]
