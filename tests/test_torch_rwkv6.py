"""The port's RWKV-6 blocks and its WKV kernel held against the JAX package,
on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages; block
weights come from the JAX package's ``timemix_init`` / ``channelmix_init``
(some leaves redrawn with numpy so that every mix, decay and bonus term
matters) and are carried across as numpy arrays.  The JAX Pallas
``rwkv6_wkv`` runs in interpret mode, as the JAX package's own tests run it
(it takes the (B, H, S, hd) layout and starts from a zero state); the
carried state is held against the JAX model's ``wkv_scan``.  Tolerances:
the reference's own for this scan, 1e-4 (``tests/test_kernels.py``), on y
and on the final state, and on the blocks in f32; 3e-2, the reference's
bf16 tolerance, on the blocks in bf16 (the two frameworks round bf16
products at other places).  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``; the ``cuda``-marked test
below does the same where a GPU is present and skips here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.rwkv6_scan.kernel import rwkv6_wkv
from repro.kernels.rwkv6_scan.ref import rwkv6_wkv_ref as jwkv_ref
from repro.models import rwkv6 as jrwkv

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda, rwkv6_wkv_ref, wkv
from repro_torch.models import rwkv6 as trwkv

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def wkv_inputs(B, S, H, hd, seed, state=False):
    """The reference test's distributions, in the model's (B, S, H, hd)
    layout: r, k halved, w = sigmoid(N) / 2 + 0.45, u N / 10; an optional
    non-zero carried state."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    out = dict(r=n(B, S, H, hd) * 0.5, k=n(B, S, H, hd) * 0.5,
               v=n(B, S, H, hd),
               w=(0.5 / (1.0 + np.exp(-n(B, S, H, hd))) + 0.45).astype(
                   np.float32),
               u=n(H, hd) * 0.1)
    out["state"] = n(B, H, hd, hd) if state else None
    return out


def torch_args(a: dict) -> dict:
    return {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in a.items()}


def bhsd(a):
    """(B, S, H, hd) <-> (B, H, S, hd), the Pallas kernel's layout."""
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


# ============================================================ rwkv6_wkv ====
#: the CUDA kernel stages 16 steps at a time: S one short of, at and one
#: past a chunk, at each head size it is built for
EDGE_S = (15, 16, 17)


@pytest.mark.parametrize("B,H,S,hd,chunk", [
    (2, 2, 64, 16, 16), (1, 4, 128, 32, 64), (2, 3, 96, 64, 32),
    (2, 3, 15, 16, 5), (1, 2, 16, 32, 8), (2, 2, 17, 64, 17),
    (1, 4, 15, 64, 15), (2, 2, 16, 16, 16), (1, 3, 17, 32, 17)])
def test_wkv_plain_matches_pallas_and_oracle(B, H, S, hd, chunk):
    """The reference test's three shapes, then S around the CUDA kernel's
    16-step chunk at hd 16, 32 and 64 (chunks that divide S), with the
    layout permuted between the port's (B, S, H, hd) and the Pallas
    kernel's (B, H, S, hd)."""
    a = wkv_inputs(B, S, H, hd, seed=B * H * S)
    y, st = wkv(**torch_args(a))
    assert y.dtype == torch.float32 and y.shape == (B, S, H, hd)
    assert st.shape == (B, H, hd, hd)
    args = [jnp.asarray(bhsd(a[k])) for k in ("r", "k", "v", "w")]
    u = jnp.asarray(a["u"])
    pallas = rwkv6_wkv(*args, u, chunk=chunk, interpret=True)
    got = bhsd(y.numpy())
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jwkv_ref(*args, u)), **TOL)


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (2, 1, 2, 16, 8), (1, 13, 3, 32, 8), (2, 48, 2, 64, 16),
    (3, 70, 1, 16, 64), (1, 15, 2, 32, 5), (2, 16, 3, 64, 16),
    (1, 17, 2, 16, 8)])
def test_wkv_carried_state_matches_model_scan(B, S, H, hd, chunk):
    """A non-zero carried state: y and the final state against the JAX
    model's ``wkv_scan`` (the function the kernel serves), for S = 1 and S
    not a multiple of the chunk; then in place, the final state written over
    the state read, as the decode does."""
    a = wkv_inputs(B, S, H, hd, seed=S + hd, state=True)
    jy, jst = jrwkv.wkv_scan(*(jnp.asarray(a[k]) for k in
                               ("r", "k", "v", "w", "u", "state")),
                             chunk=chunk)
    t = torch_args(a)
    y, st = wkv(**t)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    state = t["state"].clone()
    y2, st2 = wkv(**{**t, "state": state}, state_out=state)
    assert st2 is state
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(state, st, rtol=0, atol=0)


@pytest.mark.parametrize("S1,S2", [(5, 1), (17, 9), (1, 1), (16, 1),
                                   (16, 17), (32, 15)])
def test_wkv_split_scan_equals_whole(S1, S2):
    """A scan of S1 steps, then one of S2 from its final state, equals one
    scan of S1 + S2 (what a prefill followed by decode steps relies on),
    also split on the CUDA kernel's 16-step chunk boundaries."""
    a = torch_args(wkv_inputs(2, S1 + S2, 3, 16, seed=S1, state=True))
    y, st = rwkv6_wkv_ref(**a)
    head = {k: a[k][:, :S1] for k in ("r", "k", "v", "w")}
    tail = {k: a[k][:, S1:] for k in ("r", "k", "v", "w")}
    y1, st1 = rwkv6_wkv_ref(**head, u=a["u"], state=a["state"])
    y2, st2 = rwkv6_wkv_ref(**tail, u=a["u"], state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(st2, st, **TOL)


def test_wkv_plain_computes_in_its_inputs_dtype():
    """f64 inputs give an f64 scan that agrees with the JAX model's f32
    ``wkv_scan``; bf16 inputs give a bf16 scan (how ``chip_smoke.py`` sees
    how far two scans that round differently drift apart)."""
    a = wkv_inputs(2, 33, 3, 16, seed=7, state=True)
    jy, jst = jrwkv.wkv_scan(*(jnp.asarray(a[k]) for k in
                               ("r", "k", "v", "w", "u", "state")), chunk=8)
    t = torch_args(a)
    y, st = rwkv6_wkv_ref(**{k: v.double() for k, v in t.items()})
    assert y.dtype == st.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    yb, stb = rwkv6_wkv_ref(**{k: v.bfloat16() for k, v in t.items()})
    assert yb.dtype == stb.dtype == torch.bfloat16
    assert yb.shape == y.shape and stb.shape == st.shape


def test_wkv_dispatch_cpu_plain_and_other_devices_raise():
    t = torch_args(wkv_inputs(2, 5, 2, 16, seed=1, state=True))
    y, st = wkv(**t)
    want_y, want_st = rwkv6_wkv_ref(**t)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st, want_st, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        wkv(**{k: v.to("meta") for k, v in t.items()})


def test_rwkv6_wkv_wrapper_raises_off_the_card_and_builds_nothing():
    """CPU tensors (and non-tensors) reaching the CUDA wrapper raise before
    anything is compiled; there is no fall back to the plain version."""
    t = torch_args(wkv_inputs(1, 4, 2, 16, seed=0, state=True))
    built, launches = dict(_build._libs), rwkv6_wkv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_wkv_cuda(t["r"], t["k"], t["v"], t["w"], t["u"], t["state"])
    with pytest.raises(TypeError, match="tensor"):
        rwkv6_wkv_cuda(t["r"].numpy(), t["k"], t["v"], t["w"], t["u"])
    assert _build._libs == built and rwkv6_wkv_cuda.launches == launches


# ============================================================== the blocks ====
def block_cfg():
    return jconfigs.get_tiny_config("rwkv6-3b")


def block_params(cfg, seed):
    """JAX-initialised time-mix and channel-mix weights, with the mixes,
    the decay bias, the bonus and the LoRAs redrawn so each one moves the
    output; the same numbers as JAX arrays and as tensors."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tm = jax.tree.map(np.asarray, jrwkv.timemix_init(k1, cfg))
    cm = jax.tree.map(np.asarray, jrwkv.channelmix_init(k2, cfg))
    rng = np.random.default_rng(seed)
    u01 = lambda a: rng.random(a.shape).astype(np.float32)    # noqa: E731
    tm.update(mu_x=u01(tm["mu_x"]), mu=u01(tm["mu"]),
              w0=rng.uniform(-3.0, 0.0, tm["w0"].shape).astype(np.float32),
              u=(rng.standard_normal(tm["u"].shape) * 0.5).astype(np.float32))
    for name in ("lora_a", "lora_b", "wa", "wb"):
        tm[name] = tm[name] * 20.0
    cm.update(mu_k=u01(cm["mu_k"]), mu_r=u01(cm["mu_r"]))
    to_j = lambda p: jax.tree.map(jnp.asarray, p)              # noqa: E731
    to_t = lambda p: jax.tree.map(                             # noqa: E731
        lambda a: torch.from_numpy(np.array(a)), p)
    return (to_j(tm), to_j(cm)), (to_t(tm), to_t(cm))


def test_block_init_matches_jax_layout():
    """Same leaves, shapes and dtypes as the JAX package's initialisers;
    the constant leaves equal."""
    cfg = block_cfg()
    jtm = jrwkv.timemix_init(jax.random.PRNGKey(0), cfg)
    jcm = jrwkv.channelmix_init(jax.random.PRNGKey(1), cfg)
    gen = torch.Generator().manual_seed(0)
    ttm = trwkv.timemix_init(gen, cfg, device="cpu")
    tcm = trwkv.channelmix_init(gen, cfg, device="cpu")
    for jp, tp in ((jtm, ttm), (jcm, tcm)):
        jl = jax.tree_util.tree_flatten_with_path(jp)[0]
        tl = jax.tree_util.tree_flatten_with_path(tp)[0]
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    for k in ("mu_x", "mu", "w0", "ln_g", "ln_b"):
        np.testing.assert_array_equal(ttm[k].numpy(), np.asarray(jtm[k]))


def block_inputs(cfg, S, carried, seed, dtype):
    """x (2, S, d) and, when carried, the previous token (2, d) and a
    non-zero state (2, H, hd, hd), as numpy f32 and in ``dtype``."""
    rng = np.random.default_rng(seed)
    d, H, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_size
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    prev = rng.standard_normal((2, d)).astype(np.float32) if carried else None
    state = (rng.standard_normal((2, H, hd, hd)) * 0.5).astype(np.float32) \
        if carried else None
    return x, prev, state


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("carried", [False, True])
def test_timemix_apply_matches_jax(dtype, tol, S, carried):
    """Output, last token and final state, from zero or from a carried
    previous token and state (the decode's case at S = 1); the given state
    moves in place."""
    cfg = block_cfg()
    (jtm, _), (ttm, _) = block_params(cfg, S)
    x, prev, state = block_inputs(cfg, S, carried, S + 3, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jout, (jlast, jst) = jrwkv.timemix_apply(
        jtm, jnp.asarray(x).astype(jdt), cfg,
        None if prev is None else jnp.asarray(prev).astype(jdt),
        None if state is None else jnp.asarray(state))
    t_state = None if state is None else torch.from_numpy(state.copy())
    tout, (tlast, tst) = trwkv.timemix_apply(
        ttm, torch.from_numpy(x).to(tdt), cfg,
        None if prev is None else torch.from_numpy(prev).to(tdt), t_state)
    assert tout.dtype == tdt and tst.dtype == torch.float32
    for got, want in ((tout, jout), (tlast, jlast), (tst, jst)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    if carried:                                  # the state moved in place
        assert tst is t_state


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("carried", [False, True])
def test_channelmix_apply_matches_jax(dtype, tol, S, carried):
    cfg = block_cfg()
    (_, jcm), (_, tcm) = block_params(cfg, S)
    x, prev, _ = block_inputs(cfg, S, carried, S + 5, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jout, jlast = jrwkv.channelmix_apply(
        jcm, jnp.asarray(x).astype(jdt), cfg,
        None if prev is None else jnp.asarray(prev).astype(jdt))
    tout, tlast = trwkv.channelmix_apply(
        tcm, torch.from_numpy(x).to(tdt), cfg,
        None if prev is None else torch.from_numpy(prev).to(tdt))
    assert tout.dtype == tdt
    for got, want in ((tout, jout), (tlast, jlast)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


# ================================================= the kernel on the card ====
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("B,S,H,hd", [
    (1, 1, 4, 16), (4, 7, 40, 64), (2, 300, 3, 32),
    *((1, s, 4, hd) for s, hd in zip(EDGE_S, (64, 16, 32))),
    (4, 17, 40, 32), (2, 33, 70, 64), (1, 16, 40, 64)])
def test_rwkv6_wkv_cuda_matches_plain(cuda_device, B, S, H, hd, state):
    """y and the final state within 1e-4 of the largest plain value plus
    1e-4, and once more in place (the state passed as the output too); S
    around the kernel's 16-step chunk, B x H = 4 to 160 pairs (their
    columns over 8 down to 2 blocks)."""
    t = {k: None if v is None else v.to(cuda_device)
         for k, v in torch_args(wkv_inputs(B, S, H, hd, seed=S,
                                           state=state)).items()}
    before = rwkv6_wkv_cuda.launches
    y, st = wkv(**t)
    assert rwkv6_wkv_cuda.launches == before + 1
    want_y, want_st = rwkv6_wkv_ref(**t)
    for got, want in ((y, want_y), (st, want_st)):
        bound = 1e-4 * float(want.abs().max()) + 1e-4
        assert float((got - want).abs().max()) <= bound
    if state:
        buf = t["state"].clone()
        y2, st2 = wkv(**{**t, "state": buf}, state_out=buf)
        assert st2 is buf and torch.equal(y2, y) and torch.equal(buf, st)
