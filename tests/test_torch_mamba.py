"""The port's Mamba block and its selective-scan kernel held against the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages; block
weights come from the JAX package's ``mamba_init`` and are carried across
as numpy arrays.  The JAX Pallas ``mamba_ssm`` runs in interpret mode, as
the JAX package's own tests run it (it starts from a zero state); the
carried state is held against the JAX model's ``ssm_scan``.  Tolerance: the
reference's own for this scan, 1e-4 (``tests/test_kernels.py``), on y and
on the final state.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``; the ``cuda``-marked test below
does the same where a GPU is present and skips here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.mamba_scan.kernel import mamba_ssm
from repro.kernels.mamba_scan.ref import mamba_ssm_ref as jmamba_ssm_ref
from repro.models import mamba as jmamba

from repro_torch.kernels.mamba_scan import (mamba_ssm_cuda, mamba_ssm_ref,
                                            selective_scan)
from repro_torch.models import mamba as tmamba

TOL = dict(atol=1e-4, rtol=1e-4)


def scan_inputs(B, S, di, ds, seed, h0=False):
    """The reference test's distributions: dt = softplus(N - 1), A = -exp(
    N / 2); an optional non-zero carried state."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    out = dict(x=n(B, S, di), dt=np.log1p(np.exp(n(B, S, di) - 1.0)),
               Bmat=n(B, S, ds), Cmat=n(B, S, ds),
               A=-np.exp(n(di, ds) * 0.5), D=n(di))
    out["h0"] = n(B, di, ds) if h0 else None
    return out


def torch_args(a: dict) -> dict:
    return {k: None if v is None else torch.from_numpy(np.asarray(v,
                                                                  np.float32))
            for k, v in a.items()}


# ============================================================= mamba_ssm ====
@pytest.mark.parametrize("B,S,di,ds,chunk,bdi", [
    (2, 64, 128, 16, 32, 128), (1, 128, 256, 8, 64, 128),
    (2, 96, 64, 16, 32, 64), (3, 1, 128, 16, 1, 64),
    (1, 31, 100, 16, 31, 100), (2, 32, 100, 16, 16, 50),
    (1, 33, 68, 16, 11, 68), (1, 32, 8196, 16, 32, 4098)])
def test_selective_scan_plain_matches_pallas(B, S, di, ds, chunk, bdi):
    """The reference's shapes, then S around the CUDA kernel's 32-step
    chunk and di that is not a multiple of 4 or of its 64-channel blocks
    (chunks and channel blocks that divide them)."""
    a = scan_inputs(B, S, di, ds, seed=B * S + di)
    args = [jnp.asarray(a[k]) for k in ("x", "dt", "Bmat", "Cmat", "A", "D")]
    y, h = selective_scan(**torch_args(a))
    assert y.dtype == torch.float32 and y.shape == (B, S, di)
    assert h.shape == (B, di, ds)
    pallas = mamba_ssm(*args, chunk=chunk, block_di=bdi, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jmamba_ssm_ref(*args)),
                               **TOL)


@pytest.mark.parametrize("B,S,di", [(2, 17, 64, ), (1, 1, 128), (3, 40, 32),
                                    (1, 31, 100), (2, 32, 68),
                                    (1, 33, 8196)])
def test_selective_scan_carried_state_matches_model_scan(B, S, di):
    """A non-zero h0: y and the final state against the JAX model's
    ``ssm_scan`` (the function the kernel serves)."""
    a = scan_inputs(B, S, di, 16, seed=S, h0=True)
    jy, jh = jmamba.ssm_scan(*(jnp.asarray(a[k]) for k in
                               ("x", "dt", "Bmat", "Cmat", "A", "D", "h0")),
                             chunk=8)
    t = torch_args(a)
    y, h = selective_scan(**t)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    # in place: the final state written over h0, as the decode does
    state = t["h0"].clone()
    y2, h2 = selective_scan(**{**t, "h0": state}, h_out=state)
    assert h2 is state
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(state, h, rtol=0, atol=0)


@pytest.mark.parametrize("S1,S2", [(32, 1), (32, 31), (64, 33)])
def test_selective_scan_split_equals_whole(S1, S2):
    """A scan of S1 steps, then one of S2 from its final state, equals one
    scan of S1 + S2 (a prefill, then decode steps), split on the CUDA
    kernel's 32-step chunk boundaries."""
    a = torch_args(scan_inputs(2, S1 + S2, 100, 16, seed=S1 + S2, h0=True))
    y, h = mamba_ssm_ref(**a)
    head = {k: a[k][:, :S1] for k in ("x", "dt", "Bmat", "Cmat")}
    tail = {k: a[k][:, S1:] for k in ("x", "dt", "Bmat", "Cmat")}
    y1, h1 = mamba_ssm_ref(**head, A=a["A"], D=a["D"], h0=a["h0"])
    y2, h2 = mamba_ssm_ref(**tail, A=a["A"], D=a["D"], h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(h2, h, **TOL)


def test_mamba_ssm_wrapper_raises_off_the_card():
    t = torch_args(scan_inputs(1, 4, 8, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_ssm_cuda(**t)
    with pytest.raises(ValueError, match="no kernel"):
        selective_scan(**{k: None if v is None else v.to("meta")
                          for k, v in t.items()})


# ============================================================== the block ====
def block_cfg(**kw):
    return jconfigs.get_tiny_config("jamba-v0.1-52b").replace(**kw)


def block_params(cfg, seed):
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), cfg)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def test_mamba_init_matches_jax_layout():
    """Same leaves, shapes and dtypes; the deterministic leaves equal (D,
    conv_b) or within an f32 step (A_log: the two ``log`` implementations
    round differently); dt_bias is the inverse softplus of a dt in
    [0.001, 0.1]."""
    cfg = block_cfg()
    jp, _ = block_params(cfg, 0)
    tp = tmamba.mamba_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    for k in ("D", "conv_b"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2 ** -23, atol=0)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt > 0.00099) & (dt < 0.1001)).all())


@pytest.mark.parametrize("S", [1, 2, 9])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_apply_matches_jax(S, carried):
    """Output and both returned states, from zero or from a carried conv /
    SSM state (the decode's case at S = 1)."""
    cfg = block_cfg()
    jp, tp = block_params(cfg, S)
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    di, ds = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    conv = rng.standard_normal((2, cfg.mamba_d_conv - 1, di)).astype(
        np.float32) if carried else None
    ssm = rng.standard_normal((2, di, ds)).astype(np.float32) \
        if carried else None
    jout, (jconv, jssm) = jmamba.mamba_apply(
        jp, jnp.asarray(u), cfg,
        None if conv is None else jnp.asarray(conv),
        None if ssm is None else jnp.asarray(ssm))
    t_ssm = None if ssm is None else torch.from_numpy(ssm.copy())
    tout, (tconv, tssm) = tmamba.mamba_apply(
        tp, torch.from_numpy(u), cfg,
        None if conv is None else torch.from_numpy(conv), t_ssm)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), **TOL)
    if carried:                                  # the state moved in place
        assert tssm is t_ssm


# ================================================= the kernel on the card ====
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S,di", [(1, 1, 64), (4, 7, 8192), (2, 300, 100),
                                    (1, 31, 100), (2, 32, 8196),
                                    (1, 33, 8192)])
def test_mamba_ssm_cuda_matches_plain(cuda_device, B, S, di, h0):
    """y and the final state within the reference's 1e-4, S around the
    kernel's 32-step chunk, di that takes its 4-byte copies (100) and a
    partly filled last block (8,196); and once more in place."""
    t = {k: None if v is None else v.to(cuda_device)
         for k, v in torch_args(scan_inputs(B, S, di, 16, seed=S,
                                            h0=h0)).items()}
    before = mamba_ssm_cuda.launches
    y, h = selective_scan(**t)
    assert mamba_ssm_cuda.launches == before + 1
    want_y, want_h = mamba_ssm_ref(**t)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(h, want_h, **TOL)
    if h0:
        state = t["h0"].clone()
        y2, h2 = selective_scan(**{**t, "h0": state}, h_out=state)
        assert h2 is state and torch.equal(y2, y) and torch.equal(state, h)
