"""Model weights made by the benchmark from ``--seed``, on the device.

The benchmark makes the weights itself and hands the same values to the
program and to the plain reference.  They are drawn in groups (the
embedding, each layer, the final norm with the head), each group from its
own ``torch.Generator`` on the device, seeded from the run's seed and the
group's name, with one ``randn`` call for all of the group's matrices.  So
the reference can draw one layer again after the program is freed and get
the same numbers, on the same device.

Leaves are named by their path in the program's parameter tree
(``layers.3.moe.gate``); :func:`flat_paths` reads the program's tree
by those names.  Every layer is an
attention layer followed by routed experts, as in Granite-MoE.  Scales
follow the usual initialisation: ``1 / sqrt(fan_in)`` for matrices, 0.02
for the embedding, ones for norms.  Only ``torch`` is imported here.
"""
from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def derive(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a name."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).hexdigest()
    return int(h[:15], 16)


def generator(seed: int, name: str, device) -> torch.Generator:
    dev = torch.device(device)
    return torch.Generator(device=dev).manual_seed(derive(seed, name))


# (name, shape, kind, scale, dtype key): kind is normal | ones; dtype
# "param" takes the configuration's parameter type
Leaf = tuple


def head_dim(hf: dict) -> int:
    return hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]


def groups(hf: dict) -> list[tuple[str, list[Leaf]]]:
    """The weight groups of a configuration, in drawing order."""
    d, f, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    H, Kv, hd = hf["num_attention_heads"], hf["num_key_value_heads"], \
        head_dim(hf)
    E = hf["num_local_experts"]
    s = d ** -0.5
    out = [("embed", [("embed.table", (V, d), "normal", 0.02, "param")])]
    for i in range(hf["num_hidden_layers"]):
        p = f"layers.{i}."
        out.append((f"layer.{i}", [
            (p + "norm1.g", (d,), "ones", 1.0, "param"),
            (p + "norm2.g", (d,), "ones", 1.0, "param"),
            (p + "attn.wq.w", (d, H * hd), "normal", s, "param"),
            (p + "attn.wk.w", (d, Kv * hd), "normal", s, "param"),
            (p + "attn.wv.w", (d, Kv * hd), "normal", s, "param"),
            (p + "attn.wo.w", (H * hd, d), "normal", (H * hd) ** -0.5,
             "param"),
            (p + "moe.router.w", (d, E), "normal", s, "float32"),
            (p + "moe.gate", (E, d, f), "normal", s, "param"),
            (p + "moe.up", (E, d, f), "normal", s, "param"),
            (p + "moe.down", (E, f, d), "normal", f ** -0.5, "param")]))
    out.append(("out", [("final_norm.g", (d,), "ones", 1.0, "param"),
                        ("head.w", (d, V), "normal", s, "param")]))
    return out


def make_group(leaves: list[Leaf], seed: int, name: str, device,
               param_dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """One group's leaves: one ``randn`` for all its normal leaves, in
    f32, scaled and cast leaf by leaf."""
    gen = generator(seed, name, device)
    dev = torch.device(device)
    normal = [lf for lf in leaves if lf[2] == "normal"]
    total = sum(math.prod(lf[1]) for lf in normal)
    buf = torch.randn((total,), generator=gen, device=dev,
                      dtype=torch.float32) if total else None
    out, at = {}, 0
    for lname, shape, kind, scale, dt in leaves:
        dtype = param_dtype if dt == "param" else DTYPES[dt]
        if kind == "normal":
            n = math.prod(shape)
            t = buf[at:at + n].view(shape).mul_(scale)
            # a copy either way: a view would hold the whole buffer
            out[lname] = t.to(dtype) if dtype != t.dtype else t.clone()
            at += n
        elif kind == "ones":
            out[lname] = torch.ones(shape, dtype=dtype, device=dev)
    del buf
    return out


def make_all(hf: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of the configuration, in its trained type."""
    pdt = DTYPES[hf["param_dtype"]]
    out: dict[str, torch.Tensor] = {}
    for name, leaves in groups(hf):
        out.update(make_group(leaves, seed, name, device, pdt))
    return out


def flat_paths(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor leaf of a nested tree (``layers`` a list) by dotted
    path."""
    out: dict[str, torch.Tensor] = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, torch.Tensor):
            out[path] = val
        else:
            out.update(flat_paths(val, path + "."))
    return out
