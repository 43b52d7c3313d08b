"""The port's training path held against the JAX package, on the CPU.

Both packages run with the same weights: the JAX package initialises them,
and :func:`repro_torch.convert.model_params_from_numpy` carries them across.
Batches come from the JAX package's ``dummy_batch`` or from the same numpy
draw (``SyntheticLM``).  Tolerances, each with its reason (f32 tiny
configs; XLA and PyTorch sum in other orders):
  - loss ``rtol=1e-5``;
  - gradients per leaf within ``1e-5 * max|g|`` of the leaf plus ``rtol
    1e-4`` (measured: at most 2.3e-6 of the leaf's largest value);
  - the attention backward against the JAX custom VJP ``2e-5`` (the
    reference's f32 kernel tolerance); ``gradcheck`` in f64 at its
    defaults;
  - a train step's metrics ``rtol=1e-5`` and params ``rtol=1e-5`` plus 5 %
    of lr: the first Adam step is about g / (|g| + eps) per element, so
    where |g| is within a few eps (1e-8) of zero a last-ulp gradient
    difference moves that element's step (measured: at most 1.5 % of lr,
    on one element of 8,192);
  - the int8-compressed Trainer's losses over 5 steps ``1e-4`` relative of
    a replay of value_and_grad -> GradCompressor.compress -> adamw.update
    in JAX (the quantized gradient is exact on both sides only while the
    f32 gradients are; a one-ulp gradient difference can move one element
    by a quantum; measured: at most 8.0e-8 relative over the 5 steps).
The CUDA kernels on this path are held against their plain versions on the
card by ``chip_smoke.py``'s ``train`` phase.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim.compress import GradCompressor as JGradCompressor

from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import steps, train
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.optim import adamw

CPU = "cpu"
ARCHS = ["yi-6b", "qwen3-8b", "musicgen-medium", "qwen2-vl-2b",
         "granite-moe-1b-a400m", "jamba-v0.1-52b", "rwkv6-3b",
         "stablelm-12b", "qwen2.5-32b", "grok-1-314b"]
_j_vg = {}


def j_value_and_grad(cfg):
    if cfg not in _j_vg:
        _j_vg[cfg] = jax.jit(jax.value_and_grad(JM.apply_train, has_aux=True),
                             static_argnums=(1,))
    return _j_vg[cfg]


def ported(jparams, cfg):
    return model_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   CPU)


def t_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def assert_grads(tg, jg):
    tl, jl = leaves(tg), jax.tree.leaves(jg)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))


# ================================================================= model ====
@pytest.mark.parametrize("S", [64, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, S):
    """S = 64 is a multiple of the tiny configs' attn_block (32), S = 40
    leaves a ragged last query block; a quarter of the labels are -100.
    Granite trains through the MoE (its aux loss compared), Jamba through
    Mamba, attention, MLP and MoE layers, RWKV-6 through both of its mixes
    (one scan segment at either S: the tiny configs' chunk is 64),
    qwen2.5-32b through its QKV bias and grok-1 through a MoE without
    expert parallelism (the configs ``tests/test_torch_tp.py`` shards over
    "model")."""
    cfg = jconfigs.get_tiny_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(S), cfg)
    b = JM.dummy_batch(cfg, 2, S, key=jax.random.PRNGKey(1))
    labels = np.array(b["labels"])
    labels[np.random.default_rng(S).random(labels.shape) < 0.25] = -100
    b["labels"] = jnp.asarray(labels)
    (jl, jm), jg = j_value_and_grad(cfg)(jp, cfg, b)
    (tl, tm), tg = steps.value_and_grad(ported(jp, cfg), cfg, t_batch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("xent", "aux", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert_grads(tg, jg)


def test_remat_full_equals_none():
    cfg = configs.get_tiny_config("qwen3-8b")
    params = TM.init_params(3, cfg, device=CPU)
    batch = TM.dummy_batch(cfg, 2, 40, gen=4, device=CPU)
    outs = [steps.value_and_grad(params, cfg.replace(remat=r), batch)
            for r in ("full", "none")]
    (l1, _), g1 = outs[0]
    (l2, _), g2 = outs[1]
    assert torch.equal(l1, l2)
    for a, b in zip(leaves(g1), leaves(g2)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="dots"):
        TM.apply_train(params, cfg.replace(remat="dots"), batch)


def test_dummy_batch_shapes():
    for arch in ("yi-6b", "musicgen-medium"):
        cfg = configs.get_tiny_config(arch)
        b = TM.dummy_batch(cfg, 3, 7, device=CPU)
        assert b["labels"].shape == (3, 7)
        key = "tokens" if cfg.frontend == "tokens" else "embeds"
        assert b[key].shape[:2] == (3, 7)
        assert int(b["labels"].max()) < cfg.vocab_size


# ============================================================= attention ====
def qkv(B, S, H, Kv, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]


def test_flash_attention_passes_gradcheck_in_f64():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in qkv(1, 7, 4, 2, 8, seed=0, dtype=np.float64))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tattn.FlashAttention.apply(q, k, v, 3), (q, k, v))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S,block", [(64, 16), (45, 16)])
def test_flash_attention_gradients_match_jax_custom_vjp(G, S, block):
    arrays = qkv(2, S, 2 * G, 2, 16, seed=S + G)
    do = np.random.default_rng(9).standard_normal(arrays[0].shape).astype(
        np.float32)
    jout, vjp = jax.vjp(lambda q, k, v: jattn.causal_attention(q, k, v,
                                                               block),
                        *map(jnp.asarray, arrays))
    jgrads = vjp(jnp.asarray(do))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    out = tattn.FlashAttention.apply(q, k, v, block)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    for t, j in zip((q.grad, k.grad, v.grad), jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5,
                                   rtol=2e-5)


def test_attention_lse_matches_the_jax_forward():
    from repro_torch.kernels.flash_attention import flash_attention
    arrays = qkv(1, 50, 4, 2, 16, seed=3)
    _, jlse = jattn._fa_forward(*map(jnp.asarray, arrays), 50, True)
    out, lse = flash_attention(*map(torch.from_numpy, arrays),
                               return_lse=True)
    assert lse.shape == (1, 50, 4) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                               rtol=2e-5)


# ================================================================= steps ====
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    cfg = jconfigs.get_tiny_config("yi-6b")
    jp = JM.init_params(jax.random.PRNGKey(5), cfg)
    tp = ported(jp, cfg)
    jb = JSyntheticLM(cfg, 4, 32, seed=3).batch(0)
    jstep = jax.jit(jsteps.make_train_step(cfg, lr=1e-3, grad_accum=accum))
    jp, jo, jm = jstep(jp, jadamw.init(jp), jb)
    tstep = steps.make_train_step(configs.get_tiny_config("yi-6b"), lr=1e-3,
                                  grad_accum=accum)
    tp, to, tm = tstep(tp, init_opt(tp), t_batch(jb))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=5e-2 * 1e-3)
    assert int(to.count) == 1


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_train_step_on_embeddings_matches_jax(arch):
    """A train step of the two embeddings-frontend configs on their
    embeddings batch (``SyntheticLM``'s draw); Qwen2-VL's carries (3, B, S)
    M-RoPE positions with a patch grid per row, so t, h and w differ."""
    from test_torch_serving import patch_grid_positions
    cfg = jconfigs.get_tiny_config(arch)
    assert cfg.frontend == "embeds"
    jp = JM.init_params(jax.random.PRNGKey(6), cfg)
    tp = ported(jp, cfg)
    jb = JSyntheticLM(cfg, 4, 32, seed=3).batch(0)
    if cfg.mrope_sections:
        jb["positions"] = jnp.asarray(patch_grid_positions(
            [(4, 4), (2, 8), (3, 5), (1, 6)], 32))
    jstep = jax.jit(jsteps.make_train_step(cfg, lr=1e-3))
    jp, jo, jm = jstep(jp, jadamw.init(jp), jb)
    tp, to, tm = steps.make_train_step(cfg, lr=1e-3)(tp, init_opt(tp),
                                                      t_batch(jb))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=5e-2 * 1e-3)
    assert int(to.count) == 1


def init_opt(params):
    return adamw.init(params, "float32")


def test_mixed_precision_step_updates_the_f32_masters_in_place():
    """bf16 compute: the gradients of a bf16 copy are bf16 (as the JAX
    package's mixed precision takes them), and the step updates the f32
    master weights in place."""
    cfg = configs.get_tiny_config("qwen3-8b").replace(
        compute_dtype="bfloat16")
    params = TM.init_params(1, cfg, device=CPU)
    before = [t.clone() for t in leaves(params)]
    batch = TM.dummy_batch(cfg, 2, 16, device=CPU)
    bf16 = {k: v for k, v in params.items()}
    bf16["head"] = {"w": params["head"]["w"].to(torch.bfloat16)}
    _, grads = steps.value_and_grad(bf16, cfg, batch)
    assert grads["head"]["w"].dtype == torch.bfloat16
    assert grads["final_norm"]["g"].dtype == torch.float32
    ids = [id(t) for t in leaves(params)]
    p, _, m = steps.make_train_step(cfg, lr=1e-3)(params, init_opt(params),
                                                  batch)
    assert [id(t) for t in leaves(p)] == ids
    assert all(t.dtype == torch.float32 for t in leaves(p))
    assert all(not torch.equal(a, b) for a, b in zip(leaves(p), before))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_prefill_and_decode_steps_return_greedy_tokens():
    cfg = configs.get_tiny_config("qwen3-8b")
    params = TM.init_params(2, cfg, device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (2, 5), dtype=torch.int32)
    nxt, cache = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    logits, _ = TM.apply_prefill(params, cfg, {"tokens": toks})
    assert nxt.dtype == torch.int32 and torch.equal(
        nxt, logits.argmax(-1).to(torch.int32))
    nxt2, _ = steps.make_decode_step(cfg)(params, cache, {"tokens":
                                                          nxt[:, None]}, 4)
    assert nxt2.shape == (2,)


# =============================================================== trainer ====
def test_int8_trainer_matches_a_jax_replay():
    cfg = jconfigs.get_tiny_config("yi-6b")
    jp = JM.init_params(jax.random.PRNGKey(11), cfg)
    tr = train.Trainer(configs.get_tiny_config("yi-6b"), lr=1e-3,
                       compress="int8", device=CPU)
    tr.params = ported(jp, cfg)
    tr.opt = init_opt(tr.params)
    losses = tr.run(5, 4, 32, seed=2, log=lambda *_: None)

    comp = JGradCompressor("int8")
    vg = j_value_and_grad(cfg)

    @jax.jit
    def jstep(params, opt, ef, batch):
        (loss, m), grads = vg(params, cfg, batch)
        grads, ef, _ = comp.compress(grads, ef)
        params, opt, _ = jadamw.update(grads, opt, params, lr=1e-3)
        return params, opt, ef, loss

    data = JSyntheticLM(cfg, 4, 32, seed=2)
    opt, ef, want = jadamw.init(jp), comp.init(jp), []
    for step in range(5):
        jp, opt, ef, loss = jstep(jp, opt, ef, data.batch(step))
        want.append(float(loss))
    assert tr.step == 5 and len(losses) == 5
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_crash_restart_continues_with_the_same_losses(tmp_path):
    """Crash at step 12, restore the step-10 checkpoint, reach step 20: the
    losses of steps 11-20 equal an uninterrupted run's (the data stream is
    step-indexed and the CPU run deterministic).  Tiny Qwen2-VL trains
    through M-RoPE and the embeds frontend."""
    cfg = configs.get_tiny_config("qwen2-vl-2b")
    quiet = dict(log=lambda *_: None)
    ref = train.Trainer(cfg, lr=1e-3, device=CPU).run(20, 4, 32, **quiet)
    tr = train.Trainer(cfg, tmp_path / "ck", lr=1e-3, device=CPU)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run(20, 4, 32, ckpt_every=5, crash_at=12, **quiet)
    tr2 = train.Trainer(cfg, tmp_path / "ck", lr=1e-3, device=CPU)
    assert tr2.restore_if_any() and tr2.step == 10
    losses = tr2.run(20, 4, 32, ckpt_every=5, **quiet)
    assert tr2.step == 20 and len(losses) == 10
    assert losses == ref[10:]


def test_cli_trains_on_the_cpu_and_refuses_a_mesh(capsys):
    assert train.main(["--arch", "tiny:yi-6b", "--device", "cpu",
                       "--compress", "int8", "--steps", "2", "--batch", "2",
                       "--seq", "16"]) == 0
    assert "[train] done" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="run under torchrun"):
        train.main(["--mesh", "2x2", "--device", "cpu"])
    assert train.get_cfg("tiny:yi-6b").d_model == 64
    assert train.get_cfg("qwen3-8b").d_model == 4096
