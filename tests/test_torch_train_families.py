"""Training of the MoE, hybrid Mamba and RWKV-6 families in the port, held
against the JAX package on the CPU.

The model-level loss and gradient parity of the three tiny configs is in
``tests/test_torch_train.py::test_loss_and_gradients_match_jax``.  Here:
  - ``torch.autograd.gradcheck`` in f64 (its tolerances) of the three
    autograd functions the train path adds: the grouped matmul and the
    segmented Mamba and WKV scans, these at S = 128 in chunks of 32 (four
    segments, each recomputed from its saved starting state) in its fast
    mode (a random projection of the Jacobian: the full one costs a
    128-step forward per input element; the JAX comparisons below check
    every element);
  - the segmented scans' gradients against ``jax.vjp`` of the JAX model's
    ``ssm_scan`` / ``wkv_scan`` at four segments and at S = 100 with chunk
    64, which both packages run as one segment; with the number of
    forward and backward scans the segment rule gives (tolerance: rtol
    1e-4, atol 1e-5 of the largest gradient, the model parity's);
  - serving keeps one scan a layer (no segments, no autograd), and the
    launch counts ``chip_smoke.py`` holds each train phase to are the
    dispatching ops' calls in a Trainer step here;
  - the mixed-precision step with gradient accumulation, the int8
    Trainer against a replay of the JAX package's steps (losses 1e-4
    relative, as ``test_int8_trainer_matches_a_jax_replay``) and the CLI,
    for the tiny configs.
The CUDA kernels on these paths are held against their plain versions on
the card by ``chip_smoke.py``'s ``train_moe``, ``train_hybrid`` and
``train_rwkv`` phases.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import mamba as jmamba
from repro.models import model as JM
from repro.models import rwkv6 as jrwkv
from repro.optim import adamw as jadamw
from repro.optim.compress import GradCompressor as JGradCompressor

from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.moe_gmm import GroupedMatmul, moe_gmm_ref
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.launch import steps, train
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as trwkv
from repro_torch.optim import adamw

CPU = "cpu"
FAMILIES = ["granite-moe-1b-a400m", "jamba-v0.1-52b", "rwkv6-3b"]
QUIET = dict(log=lambda *_: None)


def scan_arrays(B, S, di, ds, seed, dtype=np.float32):
    """x, dt, Bmat, Cmat (B, S, .), A (di, ds), D (di,), h0 (B, di, ds):
    dt = softplus(N - 1) and A = -exp(N / 2), as the reference's tests."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)          # noqa: E731
    out = [n(B, S, di), np.log1p(np.exp(n(B, S, di) - 1.0)), n(B, S, ds),
           n(B, S, ds), -np.exp(n(di, ds) * 0.5), n(di), n(B, di, ds)]
    return [a.astype(dtype) for a in out]


def wkv_arrays(B, S, H, hd, seed, dtype=np.float32):
    """r, k, v, w (B, S, H, hd), u (H, hd), state (B, H, hd, hd): w in
    (0.45, 0.95), as the reference's tests."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)          # noqa: E731
    out = [n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd),
           0.5 / (1.0 + np.exp(-n(B, S, H, hd))) + 0.45, n(H, hd) * 0.1,
           n(B, H, hd, hd)]
    return [a.astype(dtype) for a in out]


def leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def assert_close_grads(got, want):
    for a, b in zip(got, want, strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))


# ============================================================ gradcheck ====
def test_grouped_matmul_passes_gradcheck_in_f64():
    rng = np.random.default_rng(0)
    x, w = leaf(rng.standard_normal((2, 5, 3))), leaf(
        rng.standard_normal((2, 3, 4)))
    assert torch.autograd.gradcheck(GroupedMatmul.apply, (x, w))


def test_grouped_matmul_f32_weights_take_the_cast_products_gradient():
    """x f64 with w f32, as the model's f32 master weights meet
    activations in another dtype: gradcheck in x, and dw is the f64 product
    x^T dy cast back to f32 (the cotangent of ``w.astype(x.dtype)``)."""
    rng = np.random.default_rng(1)
    x = leaf(rng.standard_normal((3, 4, 5)))
    w32 = torch.from_numpy(rng.standard_normal((3, 5, 2)).astype(np.float32))
    assert torch.autograd.gradcheck(lambda x: GroupedMatmul.apply(x, w32),
                                    (x,))
    w = w32.clone().requires_grad_(True)
    out = GroupedMatmul.apply(x, w)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, moe_gmm_ref(x, w32), rtol=0, atol=0)
    dy = torch.from_numpy(rng.standard_normal(out.shape))
    out.backward(dy)
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(
        w.grad, torch.bmm(x.detach().transpose(1, 2), dy).float(), rtol=0,
        atol=0)


def test_segmented_scan_passes_gradcheck_in_f64():
    args = [leaf(a) for a in scan_arrays(1, 128, 3, 2, seed=2,
                                         dtype=np.float64)]
    assert torch.autograd.gradcheck(
        lambda *a: scan_ops.segmented_scan(*a, chunk=32), args,
        fast_mode=True)


def test_segmented_wkv_passes_gradcheck_in_f64():
    args = [leaf(a) for a in wkv_arrays(1, 128, 1, 2, seed=3,
                                        dtype=np.float64)]
    assert torch.autograd.gradcheck(
        lambda *a: wkv_ops.segmented_wkv(*a, chunk=32), args,
        fast_mode=True)


# ====================================================== the JAX scans ====
def counting(monkeypatch, module, name):
    """Wrap ``module.name`` so that its calls are counted."""
    fn, calls = getattr(module, name), [0]

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("S,chunk,segments", [(128, 32, 4), (100, 64, 1)])
def test_segmented_scan_gradient_matches_jax_ssm_scan(monkeypatch, S, chunk,
                                                      segments):
    arrays = scan_arrays(2, S, 8, 16, seed=S)
    rng = np.random.default_rng(S + 1)
    dy = rng.standard_normal((2, S, 8)).astype(np.float32)
    dh = rng.standard_normal((2, 8, 16)).astype(np.float32)
    (jy, jh), vjp = jax.vjp(
        lambda *a: jmamba.ssm_scan(*a, chunk=chunk),
        *map(jnp.asarray, arrays))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    fwd = counting(monkeypatch, scan_ops, "selective_scan")
    plain = counting(monkeypatch, scan_ops, "mamba_ssm_ref")
    args = [leaf(a) for a in arrays]
    y, h = scan_ops.segmented_scan(*args, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               atol=1e-4, rtol=1e-4)
    torch.autograd.backward((y, h), (torch.from_numpy(dy),
                                     torch.from_numpy(dh)))
    assert_close_grads([a.grad for a in args], jgrads)
    # one scan a segment forward; the plain scan once a segment in each
    # direction (on the CPU the forward's scan is the plain one)
    assert (fwd[0], plain[0]) == (segments, 2 * segments)


@pytest.mark.parametrize("S,chunk,segments", [(128, 32, 4), (100, 64, 1)])
def test_segmented_wkv_gradient_matches_jax_wkv_scan(monkeypatch, S, chunk,
                                                     segments):
    arrays = wkv_arrays(2, S, 2, 8, seed=S)
    rng = np.random.default_rng(S + 1)
    dy = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    ds = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    (jy, js), vjp = jax.vjp(
        lambda *a: jrwkv.wkv_scan(*a, chunk=chunk),
        *map(jnp.asarray, arrays))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    fwd = counting(monkeypatch, wkv_ops, "wkv")
    plain = counting(monkeypatch, wkv_ops, "rwkv6_wkv_ref")
    args = [leaf(a) for a in arrays]
    y, st = wkv_ops.segmented_wkv(*args, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(js),
                               atol=1e-4, rtol=1e-4)
    torch.autograd.backward((y, st), (torch.from_numpy(dy),
                                      torch.from_numpy(ds)))
    assert_close_grads([a.grad for a in args], jgrads)
    # one scan a segment forward; the plain scan once a segment in each
    # direction (on the CPU the forward's scan is the plain one)
    assert (fwd[0], plain[0]) == (segments, 2 * segments)


def test_training_scans_by_segment_and_serving_once_a_layer(monkeypatch):
    """Tiny Jamba (three Mamba layers) and RWKV-6 (two) at S = 64 with
    chunk 16: a training forward scans four segments a layer (eight with
    ``remat="full"``, whose backward runs the layer's forward again), a
    prefill one scan a layer."""
    for arch, ops, model, name, layers in (
            ("jamba-v0.1-52b", scan_ops, tmamba, "selective_scan", 3),
            ("rwkv6-3b", wkv_ops, trwkv, "wkv", 2)):
        train_calls = counting(monkeypatch, ops, name)
        serve_calls = counting(monkeypatch, model, name)
        cfg = configs.get_tiny_config(arch).replace(mamba_chunk=16,
                                                    rwkv_chunk=16)
        params = TM.init_params(0, cfg, device=CPU)
        batch = TM.dummy_batch(cfg, 2, 64, device=CPU)
        for remat, per_layer in (("none", 4), ("full", 8)):
            train_calls[0] = 0
            steps.value_and_grad(params, cfg.replace(remat=remat), batch)
            assert train_calls[0] == per_layer * layers
        assert serve_calls[0] == 0
        steps.make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})
        assert serve_calls[0] == layers


# ================================================================ steps ====
@pytest.mark.parametrize("arch", FAMILIES)
def test_mixed_precision_step_with_accumulation_trains(arch):
    """bf16 compute (gradients of a bf16 copy), two microbatches; the f32
    masters move and the metrics are finite."""
    cfg = configs.get_tiny_config(arch).replace(compute_dtype="bfloat16")
    params = TM.init_params(1, cfg, device=CPU)
    before = [t.clone() for t in leaves(params)]
    batch = TM.dummy_batch(cfg, 4, 32, device=CPU)
    opt = adamw.init(params, "float32")
    params, opt, m = steps.make_train_step(cfg, lr=1e-3, grad_accum=2)(
        params, opt, batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["grad_norm"]) > 0
    moved = [not torch.equal(a, b) for a, b in zip(leaves(params), before)]
    assert sum(moved) >= len(moved) - 2     # all but an unused bias or two


def test_int8_granite_trainer_matches_a_jax_replay():
    arch = "granite-moe-1b-a400m"
    cfg = jconfigs.get_tiny_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(12), cfg)
    tr = train.Trainer(configs.get_tiny_config(arch), lr=1e-3,
                       compress="int8", device=CPU)
    tr.params = model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        CPU)
    tr.opt = adamw.init(tr.params, "float32")
    losses = tr.run(5, 4, 32, seed=2, **QUIET)

    comp = JGradCompressor("int8")
    vg = jax.value_and_grad(JM.apply_train, has_aux=True)

    @jax.jit
    def jstep(params, opt, ef, batch):
        (loss, _), grads = vg(params, cfg, batch)
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_trains_each_family_on_the_cpu(arch, capsys):
    """Tiny Jamba inherits grad_accum=4, so its batch is a multiple of 4."""
    assert train.main(["--arch", f"tiny:{arch}", "--device", "cpu",
                       "--compress", "int8", "--steps", "2", "--batch", "4",
                       "--seq", "32"]) == 0
    assert "[train] done" in capsys.readouterr().out


@pytest.mark.parametrize("arch,compress", [
    ("granite-moe-1b-a400m", "int8"), ("jamba-v0.1-52b", "none"),
    ("rwkv6-3b", "none")])
def test_chip_smoke_launch_counts_match_a_train_step(monkeypatch, arch,
                                                     compress):
    """``chip_smoke.launches_per_step``, which the card's train phases
    hold every kernel's launches to, against the calls one Trainer step
    makes to each dispatching op on the CPU (S = 256 in 64-step segments,
    ``remat="full"``)."""
    import chip_smoke
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models import attention as tattn
    from repro_torch.optim import compress as tcompress
    monkeypatch.setattr(chip_smoke, "TRAIN_S", 256)
    calls = {"flash_attention": counting(monkeypatch, tattn,
                                         "flash_attention"),
             "moe_gmm": counting(monkeypatch, gmm_ops, "_forward"),
             "mamba_ssm": counting(monkeypatch, scan_ops, "selective_scan"),
             "rwkv6_wkv": counting(monkeypatch, wkv_ops, "wkv"),
             "quantize_int8": counting(monkeypatch, tcompress, "quantize"),
             "dequantize_int8": counting(monkeypatch, tcompress,
                                         "dequantize")}
    cfg = configs.get_tiny_config(arch).replace(grad_accum=1)
    tr = train.Trainer(cfg, compress=compress, device=CPU)
    tr.run(1, 1, 256, **QUIET)
    want = chip_smoke.launches_per_step(cfg, len(leaves(tr.params)),
                                        compress)
    assert {name: n[0] for name, n in calls.items()} == want
