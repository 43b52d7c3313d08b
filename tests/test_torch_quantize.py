"""The port's int8 quantization held against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages (bf16
inputs are rounded from the same f32 values on both sides).  Tolerances:
  - the port's plain versions against ``optim/compress.py``'s
    ``quant_int8`` / ``dequant_int8`` and ``kernels/quantize/ref.py``: bit
    for bit (``np.array_equal``), q, scale and the dequantized values in
    f32 and bf16.  Both compute ``max(max|x|, 1e-12) / 127`` with an IEEE
    f32 division and round half to even, so nothing may differ;
  - against the Pallas kernel in interpret mode: the reference's own
    (``tests/test_kernels.py``): the scale within ``rtol=1e-6`` (the
    interpreted kernel's scale is one ulp off in some rows), q equal where
    the scale is equal and within one quantum where it is not.
The CUDA kernels are held bit-exact against the plain versions on the card
by ``chip_smoke.py``; the ``cuda``-marked test below does the same where a
GPU is present and skips here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import kernel as jkernel
from repro.kernels.quantize import ref as jref
from repro.optim import compress as jcompress

from repro_torch.kernels.quantize import (dequantize, dequantize_int8_cuda,
                                          dequantize_int8_ref, quantize,
                                          quantize_int8_cuda,
                                          quantize_int8_ref)
from repro_torch.kernels.quantize.kernel import TILE_BYTES
from repro_torch.optim import compress

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the reference test's shapes with its block_rows, and two more: one whole
#: tensor as one row (as the compression chain quantizes) and a ragged D
SHAPES = [(64, 128, 32), (256, 512, 256), (128, 384, 64), (1, 262144, 1),
          (3, 4097, 3)]


def inputs(R, D, dtype, scale=3.0, seed=0):
    x = (np.random.default_rng(seed + R * 7 + D).standard_normal((R, D))
         * scale).astype(np.float32)
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def equal(t: torch.Tensor, j) -> bool:
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.float().numpy(), np.asarray(j, np.float32))
    return np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,D,br", SHAPES)
def test_plain_is_bit_exact_with_the_jax_package(R, D, br, dtype):
    jx, tx = inputs(R, D, dtype)
    q, s = quantize(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (R, D) and s.shape == (R, 1)
    for jq, js in (jcompress.quant_int8(jx), jref.quantize_int8_ref(jx)):
        assert equal(q, jq) and equal(s, js)
    for out in ("float32", "bfloat16"):
        jd, td = DT[out]
        got = dequantize(q, s, td)
        assert got.dtype == td
        assert equal(got, jcompress.dequant_int8(jq, js, jd))
        assert equal(got, jref.dequantize_int8_ref(jq, js, jd))


@pytest.mark.parametrize("magnitude", [1e-30, 1e-8, 1.0, 1e20])
def test_plain_is_bit_exact_over_magnitudes(magnitude):
    jx, tx = inputs(16, 300, "float32", scale=magnitude, seed=9)
    q, s = quant = compress.quant_int8(tx)
    jq, js = jcompress.quant_int8(jx)
    assert equal(q, jq) and equal(s, js)
    assert equal(compress.dequant_int8(*quant), jcompress.dequant_int8(jq, js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,D,br", SHAPES)
def test_matches_the_pallas_kernel_in_interpret_mode(R, D, br, dtype):
    jx, tx = inputs(R, D, dtype, seed=1)
    jq, js = jkernel.quantize_int8(jx, block_rows=br, interpret=True)
    q, s = quantize(tx)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    same = (s.numpy() == np.asarray(js))[:, 0]
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert (dq[same] == 0).all() and (dq <= 1).all()
    got = dequantize(q, s)
    want = jkernel.dequantize_int8(jq, js, jnp.float32, block_rows=br,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=np.asarray(js).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 2, 133])
@pytest.mark.parametrize("dD", [-1, 0, 1])
def test_plain_matches_jax_around_the_kernel_tile(dD, R, dtype):
    """D one under, at and one over the CUDA kernel's 64 KB tile (16,384
    f32 or 32,768 bf16 elements), where its rows start inside tiles: the
    plain version bit for bit the JAX package's jnp ref and compression
    helper, and the Pallas kernel in interpret mode within the reference's
    tolerance (above)."""
    D = TILE_BYTES // torch.tensor([], dtype=DT[dtype][1]).element_size() \
        + dD
    jx, tx = inputs(R, D, dtype, seed=11)
    q, s = quantize_int8_ref(tx)
    for jq, js in (jref.quantize_int8_ref(jx), jcompress.quant_int8(jx)):
        assert equal(q, jq) and equal(s, js)
    kq, ks = jkernel.quantize_int8(jx, block_rows=R, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), rtol=1e-6)
    same = (s.numpy() == np.asarray(ks))[:, 0]
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(kq, np.int32))
    assert (dq[same] == 0).all() and (dq <= 1).all()


def test_all_zero_row_and_empty_rows():
    x = np.zeros((2, 50), np.float32)
    x[1] = np.linspace(-1, 1, 50)
    q, s = quantize(torch.from_numpy(x))
    jq, js = jcompress.quant_int8(jnp.asarray(x))
    assert s[0, 0].item() == np.float32(1e-12) / np.float32(127.0)
    assert (q[0] == 0).all() and equal(q, jq) and equal(s, js)
    q, s = quantize_int8_ref(torch.zeros((3, 0)))
    assert q.shape == (3, 0) and (s == s[0, 0]).all()
    assert s[0, 0].item() == np.float32(1e-12) / np.float32(127.0)
    assert dequantize_int8_ref(q, s).shape == (3, 0)


def test_one_huge_value_among_tiny_ones():
    x = np.full((1, 1000), 1e-30, np.float32)
    x[0, 500] = 1e30
    q, s = quantize(torch.from_numpy(x))
    jq, js = jcompress.quant_int8(jnp.asarray(x))
    assert equal(q, jq) and equal(s, js)
    assert q[0, 500] == 127 and int(q.abs().sum()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_inf_or_nan_quantize_to_zero_like_jax(dtype):
    """A row holding an inf has an inf scale and one holding a NaN a NaN
    scale; every element of either quantizes to 0 in the JAX package (x /
    inf is 0, inf / inf and NaN are NaN, which its clip keeps and the int8
    conversion makes 0) and in the port's plain version, which the CUDA
    kernel is held to bit for bit on the card."""
    x = np.random.default_rng(4).standard_normal((4, 300)).astype(
        np.float32) * 3
    x[0, 7], x[0, 100] = np.inf, -np.inf
    x[1, 50] = np.nan
    x[2, 9] = np.inf
    jd, td = DT[dtype]
    q, s = quantize_int8_ref(torch.from_numpy(x).to(td))
    for jq, js in (jref.quantize_int8_ref(jnp.asarray(x, jd)),
                   jcompress.quant_int8(jnp.asarray(x, jd))):
        assert equal(q, jq)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not q[:3].any() and q[3].abs().max() == 127
    assert np.isinf(s[0, 0].item()) and np.isnan(s[1, 0].item())


def test_compress_helpers_keep_leading_dims():
    jx, tx = inputs(6, 40, "float32", seed=3)
    q, s = compress.quant_int8(tx.reshape(2, 3, 40))
    assert q.shape == (2, 3, 40) and s.shape == (2, 3, 1)
    jq, js = jcompress.quant_int8(jx.reshape(2, 3, 40))
    assert equal(q, jq) and equal(s, js)
    out = compress.dequant_int8(q, s, torch.float16)
    assert out.dtype == torch.float16 and equal(
        out, jcompress.dequant_int8(jq, js, jnp.float16))


def test_ops_raise_on_other_devices_and_wrappers_refuse_cpu():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="no kernel"):
        quantize(x.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dequantize(x.to(torch.int8).to("meta"), torch.ones((2, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_int8_cuda(x.to(torch.int8), torch.ones((2, 1)))


# ================================================ the kernels on the card ====
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,D", [(1, 1), (3, 4097), (256, 512),
                                 (1, 1 << 20)])
def test_kernels_are_bit_exact_with_plain(cuda_device, R, D, dtype):
    _, tx = inputs(R, D, dtype, seed=5)
    x = tx.to(cuda_device)
    before = quantize_int8_cuda.launches, dequantize_int8_cuda.launches
    q, s = quantize(x)
    outs = [dequantize(q, s, td) for td in (torch.float32, torch.bfloat16)]
    assert (quantize_int8_cuda.launches, dequantize_int8_cuda.launches) == \
        (before[0] + 1, before[1] + 2)
    qr, sr = quantize_int8_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    for out, td in zip(outs, (torch.float32, torch.bfloat16)):
        assert torch.equal(out, dequantize_int8_ref(qr, sr, td))
