"""The port's MoE layer and its grouped-matmul kernel held against the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages (bf16
inputs rounded from the same f32 values on both sides); layer weights come
from the JAX package's ``moe_init`` and are carried across as numpy arrays.
The JAX Pallas ``moe_gmm`` runs in interpret mode, as the JAX package's own
tests run it; the port's ``grouped_matmul`` takes its plain PyTorch version
for CPU tensors.  Tolerances: the reference's own for the kernel
(``tests/test_kernels.py``: f32 2e-5, bf16 3e-2); 1e-4 for the f32 layer
(summation order differs between XLA and PyTorch).  Routing (``idx``) and
the capacity bookkeeping must agree exactly.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``; the
``cuda``-marked tests below do the same where a GPU is present and skip
here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.moe_gmm.kernel import moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jmoe_gmm_ref
from repro.models import moe as jmoe

from repro_torch.kernels.moe_gmm import (grouped_matmul, moe_gmm_cuda,
                                         moe_gmm_ref)
from repro_torch.models import moe as tmoe

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


def gmm_inputs(E, M, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, M, d)).astype(np.float32),
            (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32))


# ================================================================ moe_gmm ====
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,d,f,bc,bf,bd", [
    (4, 128, 256, 512, 128, 128, 128),
    (2, 384, 512, 384, 128, 128, 256),
    (3, 16, 64, 32, 16, 32, 64),          # tiny Granite's expert widths
])
def test_moe_gmm_plain_matches_pallas(E, M, d, f, bc, bf, bd, dtype):
    x, w = gmm_inputs(E, M, d, f, seed=E + M)
    jx, tx = pair(x, dtype)
    jw, tw = pair(w, dtype)
    got = grouped_matmul(tx, tw)
    assert got.dtype == DT[dtype][1] and got.shape == (E, M, f)
    pallas = moe_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd,
                     interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(jmoe_gmm_ref(jx, jw)),
                               **TOL[dtype])


@pytest.mark.parametrize("E,M,d,f", [(2, 7, 64, 100), (1, 1, 24, 8),
                                     (3, 200, 40, 12)])
def test_moe_gmm_plain_ragged_matches_ref(E, M, d, f):
    """Row counts and widths the Pallas kernel's block asserts refuse."""
    x, w = gmm_inputs(E, M, d, f, seed=M)
    for dtype in ("float32", "bfloat16"):
        jx, tx = pair(x, dtype)
        jw, tw = pair(w, dtype)
        np.testing.assert_allclose(f32(grouped_matmul(tx, tw)),
                                   f32(jmoe_gmm_ref(jx, jw)), **TOL[dtype])


# the CUDA kernel's tile edges: M 63 / 64 / 65 around the decode
# configuration's 64 rows, 448 = two 224-row tiles, a decode launch's 4
# rows; d 72 (fewer 32-deep K tiles than the ring's stages, a ragged one)
# and 100 (not a multiple of 8); f 264 (a ragged 128-column tile) and 1,030
# (not a multiple of 4).  (E, M, d, f, Pallas blocks (bc, bf, bd) or None
# where no block divides the shape, which the JAX ``ref`` then takes)
EDGE_SHAPES = [
    (1, 63, 72, 264, None),
    (1, 64, 128, 256, (64, 128, 128)),
    (2, 65, 100, 1030, None),
    (1, 448, 128, 128, (64, 128, 128)),
    (2, 4, 100, 264, None),
]


@pytest.mark.parametrize("route", ["f32", "bf16", "bf16_f32w"])
@pytest.mark.parametrize("E,M,d,f,blocks", EDGE_SHAPES)
def test_moe_gmm_plain_matches_jax_at_tile_edges(E, M, d, f, blocks, route):
    """The plain version, which the CUDA kernel is held against on the
    card, against the JAX package at the kernel's tile edges, on each of
    the kernel's routes (x, w) = (f32, f32), (bf16, bf16), (bf16, f32)."""
    x, w = gmm_inputs(E, M, d, f, seed=M + d)
    dtype = "float32" if route == "f32" else "bfloat16"
    jx, tx = pair(x, dtype)
    jw, tw = pair(w, dtype)
    if route == "bf16_f32w":
        tw = torch.from_numpy(w)        # the model's f32 expert weights
    got = grouped_matmul(tx, tw)
    assert got.dtype == DT[dtype][1] and got.shape == (E, M, f)
    if blocks is None:
        want = jmoe_gmm_ref(jx, jw)
    else:
        bc, bf, bd = blocks
        want = moe_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd,
                       interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_moe_gmm_bf16_activations_f32_weights_round_weights_first():
    """The model's route: bf16 rows, f32 expert weights taken in bf16 at
    use, as the JAX model's ``p["gate"].astype(x.dtype)`` does."""
    x, w = gmm_inputs(2, 128, 256, 128, seed=5)
    jx, tx = pair(x, "bfloat16")
    got = grouped_matmul(tx, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = moe_gmm(jx, jnp.asarray(w).astype(jnp.bfloat16), block_c=128,
                   block_f=128, block_d=128, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["bfloat16"])


def test_moe_gmm_wrapper_raises_off_the_card():
    """The CUDA wrapper takes nothing it cannot launch: CPU tensors, a
    route outside its three, a shape mismatch."""
    x, w = (torch.from_numpy(a) for a in gmm_inputs(2, 4, 8, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm_cuda(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        grouped_matmul(x.to("meta"), w.to("meta"))


# ============================================================== the layer ====
def layer_cfg(arch, **kw):
    return jconfigs.get_tiny_config(arch).replace(**kw)


def layer_io(cfg, B, S, seed):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("arch,kw", [
    ("granite-moe-1b-a400m", {}),
    ("jamba-v0.1-52b", {}),
    ("granite-moe-1b-a400m", {"moe_capacity_factor": 0.5}),   # drops
    ("jamba-v0.1-52b", {"moe_capacity_factor": 1.0}),         # drops
    ("granite-moe-1b-a400m", {"moe_dense_mode": True}),
])
def test_moe_apply_matches_jax(arch, kw):
    """Gates, expert indices, aux loss and output against the JAX layer:
    capacity dispatch with and without dropped slots, and the dense-mode
    branch."""
    cfg = layer_cfg(arch, **kw)
    jp, tp, x = layer_io(cfg, B=3, S=11, seed=len(kw) + cfg.n_experts)
    jg, ji, jaux = jmoe.router_topk(jp, jnp.asarray(x), cfg)
    tg, ti, taux = tmoe.router_topk(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jy, jaux2 = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    ty, taux2 = tmoe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux2), float(jaux2), rtol=1e-5)
    if kw.get("moe_capacity_factor", 8.0) <= 1.0:
        C = tmoe.capacity(11, cfg)
        assert C == jmoe.capacity(11, cfg)
        _, _, keep, _, _ = tmoe._group_dispatch(
            torch.from_numpy(x), tg, ti, cfg.n_experts, C)
        assert not bool(keep.all())               # some slots were dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_one_token_decode_shape(dtype):
    """S = 1, the decode step: capacity is top_k slots per expert."""
    cfg = layer_cfg("jamba-v0.1-52b")
    jp, tp, x = layer_io(cfg, B=4, S=1, seed=3)
    jx, tx = pair(x, dtype)
    jy, _ = jmoe.moe_apply(jp, jx, cfg)
    ty, _ = tmoe.moe_apply(tp, tx, cfg)
    assert ty.dtype == DT[dtype][1]
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(f32(ty), f32(jy), atol=tol, rtol=tol)


def test_router_ties_keep_the_lower_expert_first():
    """Equal probabilities (a zero router): both packages pick experts
    0..k-1 in order, as ``jax.lax.top_k`` orders ties."""
    cfg = layer_cfg("granite-moe-1b-a400m")
    jp, tp, x = layer_io(cfg, B=2, S=5, seed=1)
    jp = {**jp, "router": {"w": jnp.zeros_like(jp["router"]["w"])}}
    tp = {**tp, "router": {"w": torch.zeros_like(tp["router"]["w"])}}
    _, ji, _ = jmoe.router_topk(jp, jnp.asarray(x), cfg)
    _, ti, _ = tmoe.router_topk(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0, 0].tolist() == list(range(cfg.moe_top_k))


@pytest.mark.parametrize("tokens", [1, 5, 64, 1240])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_capacity_matches_jax_at_full_size(arch, tokens):
    cfg = jconfigs.get_config(arch)
    assert tmoe.capacity(tokens, cfg) == jmoe.capacity(tokens, cfg)


# ================================================= the kernel on the card ====
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bf16", "bf16_f32w", "f32"])
@pytest.mark.parametrize("E,M,d,f", [(1, 1, 64, 100), (16, 200, 1024, 512),
                                     (3, 7, 24, 8),
                                     *(shape[:4] for shape in EDGE_SHAPES),
                                     (16, 448, 4096, 1030)])
def test_moe_gmm_cuda_matches_plain(cuda_device, E, M, d, f, route):
    x, w = (torch.from_numpy(a).to(cuda_device)
            for a in gmm_inputs(E, M, d, f, seed=M))
    if route != "f32":
        x = x.to(torch.bfloat16)
    if route == "bf16":
        w = w.to(torch.bfloat16)
    before = moe_gmm_cuda.launches
    got = grouped_matmul(x, w)
    assert moe_gmm_cuda.launches == before + 1
    tol = TOL["float32" if route == "f32" else "bfloat16"]
    torch.testing.assert_close(got.float(), moe_gmm_ref(x, w).float(), **tol)
