"""Training cells: the program's ``Trainer`` step, compressed, on one
card.

Set-up builds one ``Trainer`` (the configuration's optimizer and
compression), loads into it the weights the benchmark made from
``--seed``, and drives its step through the first ``reference_steps``
steps on the traffic's rows; after the first it reads each leaf's first
gradient as AdamW took it (the first moment over ``1 - b1``), after the
last each leaf's change.  The window then drives the same step on fresh
rows until ``--seconds`` have passed, keeping one step in flight: a step's
end is read from an event the step after it has been launched.
``train_tokens_s`` is every window step's tokens over the time from the
first step's start to the last one's synchronised end.

With ``--trace 1`` the harness wraps, from here, the step's gradient,
compression and AdamW calls (spans; the compression synchronised on both
sides for ``compress_ms.train``) and the experts' dispatch (routed-slot
counts).  After the window, with the program freed, the plain reference
runs the same first steps from the same weights and rows.
"""
from __future__ import annotations

import gc
import time

import torch

from . import traffic as T
from . import weights as W
from .trace import DeviceTrace, MoeCounter, Spans

#: the file's ``runs`` keys the program has no setting for: it runs each
#: at 1 (and keeps its head untied)
NO_SETTING = ("embedding_multiplier", "residual_multiplier", "logits_scaling",
              "tie_word_embeddings")


def port_config(hf: dict, configs):
    """The program's configuration the file names, with its ``replace``
    entries, held to the file's published widths and to the values it
    says the program runs (``runs``)."""
    cfg = configs.get_config(hf["port"]["arch"]).replace(
        **hf["port"].get("replace", {}))
    want = {"n_layers": hf["num_hidden_layers"], "d_model":
            hf["hidden_size"], "n_heads": hf["num_attention_heads"],
            "n_kv_heads": hf["num_key_value_heads"], "d_ff":
            hf["intermediate_size"], "vocab_size": hf["vocab_size"],
            "hd": W.head_dim(hf), "n_experts": hf["num_local_experts"],
            "moe_top_k": hf["num_experts_per_tok"],
            "moe_capacity_factor": hf["moe_capacity_factor"],
            "moe_aux_coeff": hf["load_balance_coef"],
            "moe_z_coeff": hf["router_z_loss_coef"],
            "param_dtype": hf["param_dtype"],
            "compute_dtype": hf["compute_dtype"],
            "rope_theta": hf["rope_theta"]}
    for key, val in want.items():
        if getattr(cfg, key) != val:
            raise ValueError(f"{hf['port']['arch']}: the program's {key} is "
                             f"{getattr(cfg, key)!r}, the file's {val!r}")
    for i in range(cfg.n_layers):
        if (cfg.mixer_kind(i), cfg.channel_kind(i)) != ("attn", "moe"):
            raise ValueError(f"layer {i}: the program runs "
                             f"{cfg.mixer_kind(i)}/{cfg.channel_kind(i)}, "
                             f"the file an attention and experts layer")
    runs = hf["runs"]
    for key in NO_SETTING:
        if hasattr(cfg, key) or runs[key] not in (1.0, False):
            raise ValueError(f"{key}: the file says the program runs "
                             f"{runs[key]!r}; the program has "
                             f"{getattr(cfg, key, 'no setting')!r}")
    if runs["attention_multiplier"] != cfg.hd ** -0.5:
        raise ValueError(f"the program scales attention scores by "
                         f"{cfg.hd ** -0.5!r}, the file says "
                         f"{runs['attention_multiplier']!r}")
    return cfg


#: the numbers that decide ``correct``, each held to the file's limit
COMPARED = ("loss_rel_gap", "grad_norm_gap", "change_norm_gap",
            "change_median_gap")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


class Wrappers:
    """``--trace 1`` instrumentation of the trainer's step."""

    def __init__(self, tr, hf: dict, spans: Spans):
        from repro_torch.launch import train as LT
        from repro_torch.optim import adamw
        self.compress_s: list[float] = []
        self.tr = tr
        self._saved = [(LT, "value_and_grad", LT.value_and_grad),
                       (adamw, "update", adamw.update)]
        self.moe = MoeCounter(hf)
        vg, upd = (s[2] for s in self._saved)
        comp = tr.compressor.compress
        dev = tr.device

        def grad(*a, **k):
            with spans.span("grad"):
                return vg(*a, **k)

        def update(*a, **k):
            with spans.span("adamw"):
                return upd(*a, **k)

        def compress(*a, **k):
            sync(dev)
            t = time.perf_counter()
            with spans.span("compress"):
                out = comp(*a, **k)
                sync(dev)
            self.compress_s.append(time.perf_counter() - t)
            return out

        LT.value_and_grad, adamw.update = grad, update
        tr.compressor.compress = compress

    def remove(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self.moe.remove()
        del self.tr.compressor.compress

    def read(self) -> dict:
        return {"compress_s": self.compress_s, "moe": self.moe.read()}


def leaf_norms(tree) -> dict[str, float]:
    return {n: float(t.float().norm()) for n, t in W.flat_paths(tree).items()}


def start(ctx):
    """Set-up: one ``Trainer`` with the benchmark's weights, driven through
    the first ``reference_steps`` steps.  Returns (trainer, error-feedback
    state, the readings the check compares, phase seconds)."""
    from repro_torch import configs
    from repro_torch.launch.train import Trainer

    hf, mix, dev = ctx.hf, ctx.mix, ctx.device
    cfg = port_config(hf, configs)
    phases, t = {}, time.time()
    opt = hf["optimizer"]
    tr = Trainer(cfg, None, lr=opt["lr"], eps=opt["eps"],
                 compress=opt["compress"], seed=ctx.seed, device=dev)
    mine = W.make_all(hf, ctx.seed, dev)
    theirs = W.flat_paths(tr.params)
    if set(mine) != set(theirs):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(mine) ^ set(theirs))[:8]}")
    with torch.no_grad():
        for n, leaf in theirs.items():
            leaf.copy_(mine[n])
    first = {n: t.clone() for n, t in mine.items()}
    del mine
    ef = tr.compressor.init(tr.params)
    sync(dev)
    phases["weights_s"], t = time.time() - t, time.time()
    vocab, b1 = hf["vocab_size"], opt["b1"]
    losses, grad1 = [], {}
    k = mix["reference_steps"]
    for s in range(1, k + 1):
        batch = T.train_batch(mix, ctx.seed, s, vocab, dev)
        tr.params, tr.opt, ef, m = tr.step_fn(
            tr.params, tr.opt, ef, {"tokens": batch[0], "labels": batch[1]})
        losses.append(m["loss"])
        if s == 1:
            grad1 = {n: v / (1 - b1) for n, v in leaf_norms(tr.opt.m).items()}
    with torch.no_grad():
        change = {n: float((p.float() - first[n].float()).norm())
                  for n, p in W.flat_paths(tr.params).items()}
    del first
    sync(dev)
    phases["first_steps_s"] = time.time() - t
    prog = {"loss": [float(x) for x in losses], "grad": grad1,
            "change": change}
    return tr, ef, prog, phases


def run(ctx) -> dict:
    hf, mix, dev = ctx.hf, ctx.mix, ctx.device
    tr, ef, prog, phases = start(ctx)
    vocab, k = hf["vocab_size"], mix["reference_steps"]
    spans, wr, dt = Spans(), None, None
    if ctx.trace:
        wr = Wrappers(tr, hf, spans)
        dt = DeviceTrace().__enter__() if dev.type == "cuda" else None
    t0, t0_ns = time.time(), time.time_ns()
    step, ends = k, []
    while True:
        step += 1
        batch = T.train_batch(mix, ctx.seed, step, vocab, dev)
        tr.params, tr.opt, ef, _ = tr.step_fn(
            tr.params, tr.opt, ef, {"tokens": batch[0], "labels": batch[1]})
        if dev.type == "cuda":
            e = torch.cuda.Event()
            e.record()
            ends.append(e)
            if len(ends) > 1:
                ends[-2].synchronize()
                if time.time() - t0 >= ctx.seconds:
                    break
        elif time.time() - t0 >= ctx.seconds:
            break
    sync(dev)
    t1, t1_ns = time.time(), time.time_ns()
    steps = step - k
    rec = {"kind": "train", "hf": hf, "mix": mix, "t_start": ctx.t_start,
           "t0": t0, "t1": t1, "steps": steps,
           "tokens": steps * mix["rows"] * mix["seq"]}
    if dt is not None:
        dt.__exit__(None, None, None)
        rec["trace"] = dt.read(t0_ns, t1_ns, spans)
    if wr is not None:
        rec.update(wr.read())
        wr.remove()
    rec["memory_peak_bytes"] = peak_bytes(dev)
    del tr, ef, wr, dt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    rec["check"] = check(ctx, prog)
    rec["check"]["attempted"] = k + steps
    phases["check_s"] = time.time() - t
    rec["phases"] = phases
    return rec


def reference_run(hf: dict, mix: dict, seed: int, dev, pr=None,
                  param_dtype=torch.float32, rows=None) -> dict:
    """The plain reference's first steps from the benchmark's weights and
    rows (``rows`` keeps only that many of each batch's rows)."""
    from bench.reference import model as R
    from bench.reference import train as RT
    R.exact_f32()
    weights = W.make_all(hf, seed, dev)
    batches = []
    for s in range(1, mix["reference_steps"] + 1):
        tok, lab = T.train_batch(mix, seed, s, hf["vocab_size"], dev)
        batches.append((tok[:rows], lab[:rows]))
    out = RT.train(hf, weights, batches, pr or R.F32, param_dtype)
    del weights
    return out


def gaps(prog: dict, ref: dict, rule: float = 1e-3) -> dict:
    """The numbers compared: the largest relative gap of a step's loss;
    of a leaf's first-gradient norm and of its change's norm, each against
    the larger of the reference's norm of that leaf and of the median
    leaf; and the median leaf's gap of the change's norm.  Leaves whose
    reference gradient is under ``rule`` of the median leaf's are left out
    of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))

    def leaf_gaps(key, names):
        med = sorted(ref[key][n] for n in names)[len(names) // 2]
        return sorted(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med)
                      for n in names)

    names = sorted(ref["grad"])
    raw = sorted(ref["grad_raw"].values())
    med_raw = raw[len(raw) // 2]
    moved = [n for n in names if ref["grad_raw"][n] >= rule * med_raw]
    change = leaf_gaps("change", moved)
    return {"loss_rel_gap": loss, "grad_norm_gap": leaf_gaps("grad", names)[-1],
            "change_norm_gap": change[-1],
            "change_median_gap": change[len(change) // 2],
            "left_out": sorted(set(names) - set(moved))}


def check(ctx, prog: dict) -> dict:
    ref = reference_run(ctx.hf, ctx.mix, ctx.seed, ctx.device)
    g = gaps(prog, ref)
    lim = ctx.hf["limits"]
    compared = {k: (g[k], lim[k]) for k in COMPARED}
    return {"failed": 0, "compared": compared, "left_out": g["left_out"],
            "ref": ref, "prog": prog,
            "correct": all(v <= lm for v, lm in compared.values())}


__all__ = ["check", "gaps", "peak_bytes", "port_config", "reference_run",
           "run", "start", "sync"]
