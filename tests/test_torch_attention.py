"""The port's attention and layers held against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages (bf16
inputs are rounded from the same f32 values on both sides).  The JAX Pallas
flash-attention kernel runs in interpret mode, as the JAX package's own
tests run it; the port's ``flash_attention`` takes its plain PyTorch
version for CPU tensors.  Tolerances are the reference's own
(``tests/test_kernels.py``): f32 2e-5, bf16 3e-2.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``; the
``cuda``-marked tests below do the same where a GPU is present and skip
here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_tpu
from repro.models import attention as jattn
from repro.models import layers as jlayers

from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import layers

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(x: np.ndarray, dtype: str):
    """One f32 numpy array -> (JAX array, CPU tensor) of ``dtype``."""
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def qkv(B, S, H, Kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]


# ======================================================== flash attention ====
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kv,hd", [
    (2, 64, 4, 4, 32),      # G = 1 (MHA)
    (1, 50, 4, 2, 16),      # G = 2, ragged S
    (2, 7, 8, 2, 64),       # G = 4, ragged S
    (1, 1, 4, 1, 16),       # G = 4, one token
    (3, 33, 8, 4, 32),      # G = 2, odd batch, ragged S
])
def test_flash_attention_matches_pallas_kernel(B, S, H, Kv, hd, causal,
                                               dtype):
    arrays = qkv(B, S, H, Kv, hd, seed=B * 100 + S)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in arrays)
    want = flash_attention_tpu(jq, jk, jv, causal=causal, block_q=S,
                               block_k=S, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DT[dtype][1] and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Kv,hd", [
    (1, 100, 4, 4, 16),     # G = 1; the XLA fallback pads 100 -> 128
    (2, 45, 4, 2, 32),      # G = 2
    (1, 96, 8, 2, 16),      # G = 4, a block multiple
])
def test_flash_attention_matches_model_fallback(B, S, H, Kv, hd, dtype):
    """The port's causal attention against the JAX model's XLA fallback
    (``causal_attention``, block 32, which pads S to a block multiple)."""
    arrays = qkv(B, S, H, Kv, hd, seed=S)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in arrays)
    want = jattn.causal_attention(jq, jk, jv, 32)
    got = flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


#: sequence lengths on each side of the CUDA bf16 body's 64-key tiles and
#: (at G 4 and 8) its 32- and 16-query tiles, and serve's prefill group
EDGE_S = [63, 65, 129, 1237]


@pytest.mark.parametrize("hd", [64, 128, 160])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("S", EDGE_S)
def test_flash_attention_plain_matches_jax_at_tile_edges(S, G, hd):
    """The plain version, which the CUDA kernel is held against on the
    card, against the JAX package at the kernel's tile edges: the output
    against the Pallas kernel in interpret mode (one block of S, the only
    block that divides these S) in f32 and bf16, and the LSE against the
    JAX model's ``_fa_forward`` (one query block), causal."""
    arrays = qkv(1, S, G, 1, hd, seed=S + G + hd)
    for dtype in ("float32", "bfloat16"):
        (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in arrays)
        got, lse = flash_attention(tq, tk, tv, causal=True, return_lse=True)
        want = flash_attention_tpu(jq, jk, jv, causal=True, block_q=S,
                                   block_k=S, interpret=True)
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
        if dtype == "float32":
            _, jlse = jattn._fa_forward(jq, jk, jv, S, True)
            np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                                       **TOL[dtype])


def test_kernel_head_dims_cover_every_config_with_attention():
    """On CUDA every attention call launches the kernel, which raises for a
    head dim it is not instantiated for; the JAX package serves and trains
    every config at any head dim.  So every config with an attention layer
    must have its head dim in ``HEAD_DIMS`` (stablelm-12b's is 160)."""
    from repro_torch.configs import ARCH_NAMES, get_config
    dims = {name: get_config(name).hd for name in ARCH_NAMES
            if any(m == "attn" for m, _ in get_config(name).layer_kinds())}
    assert dims["stablelm-12b"] == 160
    assert {n: hd for n, hd in dims.items() if hd not in HEAD_DIMS} == {}


def test_plain_version_is_the_reference_oracle():
    """``attention_ref`` against the JAX package's naive oracle."""
    from repro.kernels.flash_attention import attention_ref as jref
    arrays = qkv(2, 19, 8, 2, 16, seed=5)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, "float32") for a in arrays)
    for causal in (True, False):
        np.testing.assert_allclose(
            f32(attention_ref(tq, tk, tv, causal)),
            f32(jref(jq, jk, jv, causal)), atol=2e-6, rtol=2e-6)


def test_cuda_wrapper_refuses_cpu_tensors_and_ops_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 64))
    k = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


# ================================================================= layers ====
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx, tx = pair(x, dtype)
    got = layers.rmsnorm({"g": torch.from_numpy(g)}, tx)
    want = jlayers.rmsnorm({"g": jnp.asarray(g)}, jx)
    assert got.dtype == DT[dtype][1]
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    got = layers.layernorm({"g": torch.from_numpy(g),
                            "b": torch.from_numpy(b)}, tx)
    want = jlayers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jx)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    for kind in ("rmsnorm", "layernorm"):
        p = {"g": g, "b": b} if kind == "layernorm" else {"g": g}
        got = layers.norm_apply(kind, {k: torch.from_numpy(v)
                                       for k, v in p.items()}, tx)
        want = jlayers.norm_apply(kind, {k: jnp.asarray(v)
                                         for k, v in p.items()}, jx)
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
@pytest.mark.parametrize("pos_shape", ["1d", "2d"])
def test_rope_matches_jax(theta, pos_shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    if pos_shape == "1d":
        pos = np.arange(9, dtype=np.int32)
    else:       # left-padded rows and decode positions past the prompt
        pos = np.stack([np.arange(9), np.arange(1000, 1009)]).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


def test_mrope_is_not_ported_yet():
    """The name dates from when ``apply_mrope`` raised; it is ported now and
    held against the JAX function: Qwen2-VL's sections (2, 3, 3) at hd 16
    and the (2, 1, 1) split at hd 8, with distinct t/h/w positions."""
    rng = np.random.default_rng(6)
    for hd, sections in ((16, (2, 3, 3)), (8, (2, 1, 1))):
        x = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
        pos = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
        got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                 1e6, sections)
        want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                   sections)
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(kind, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    names = ("gate", "up", "down") if kind == "swiglu" else ("up", "down")
    p = {n: {"w": (rng.standard_normal((64, 32) if n == "down" else (32, 64))
                   / 8).astype(np.float32)} for n in names}
    jx, tx = pair(x, dtype)
    got = layers.mlp({n: {"w": torch.from_numpy(v["w"])}
                      for n, v in p.items()}, tx, kind)
    want = jlayers.mlp({n: {"w": jnp.asarray(v["w"])} for n, v in p.items()},
                       jx, kind)
    assert got.dtype == DT[dtype][1]
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_linear_and_embed_match_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    got = layers.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x).to(torch.bfloat16))
    want = jlayers.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **TOL["bfloat16"])
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[0, 9, 3]], np.int32)
    np.testing.assert_array_equal(
        layers.embed({"table": torch.from_numpy(table)},
                     torch.from_numpy(ids)).numpy(),
        np.asarray(jlayers.embed({"table": jnp.asarray(table)},
                                 jnp.asarray(ids))))


# ================================================= the kernel on the card ====
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda", 0)


#: the tile edges at G 4 and 8, hd 64 and 128, on the card
EDGE_CUDA_SHAPES = [(1, S, 4 * G, 4, hd) for S in EDGE_S for G in (4, 8)
                    for hd in (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kv,hd", [(1, 1, 8, 8, 64), (2, 77, 32, 8, 128),
                                         (1, 300, 16, 2, 64),
                                         *EDGE_CUDA_SHAPES])
def test_flash_attention_cuda_matches_plain(cuda_device, B, S, H, Kv, hd,
                                            causal, dtype):
    td = DT[dtype][1]
    q, k, v = (torch.from_numpy(a).to(cuda_device, td)
               for a in qkv(B, S, H, Kv, hd, seed=S))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, causal).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kv,hd", EDGE_CUDA_SHAPES)
def test_flash_attention_cuda_lse_matches_plain(cuda_device, B, S, H, Kv, hd,
                                                causal, dtype):
    """The instantiation with the LSE epilogue at the tile edges: the
    output the same as without the LSE, and the LSE within the output's
    tolerance of the plain version's."""
    td = DT[dtype][1]
    q, k, v = (torch.from_numpy(a).to(cuda_device, td)
               for a in qkv(B, S, H, Kv, hd, seed=S))
    got, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want, want_lse = attention_ref(q, k, v, causal, return_lse=True)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[dtype])
