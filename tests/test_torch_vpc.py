"""The PyTorch port's VPC datapath held against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages.  All the
arithmetic is integer, so the tolerance is exact equality everywhere.  The
JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them; the port's kernel wrappers take their plain PyTorch versions for
CPU tensors.  The CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``; the ``cuda``-marked tests below
do the same where a GPU is present and skip here.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.chacha20 import ops as jax_chacha_ops
from repro.kernels.chacha20.kernel import chacha20_xor as jax_chacha_kernel
from repro.kernels.chacha20.ref import chacha20_xor_ref
from repro.kernels.vpc_datapath import vpc_datapath as jax_vpc_datapath
from repro.serving import vpc as jvpc

from repro_torch import _u32
from repro_torch.kernels import _build
from repro_torch.kernels.chacha20 import core
from repro_torch.kernels.chacha20 import ops as chacha_ops
from repro_torch.kernels.chacha20.kernel import (chacha20_xor,
                                                 chacha20_xor_plain)
from repro_torch.kernels.vpc_datapath import kernel as vpc_kernel
from repro_torch.kernels.vpc_datapath import vpc_datapath, vpc_datapath_ref
from repro_torch.kernels.vpc_datapath.ops import rule_table
from repro_torch.serving import vpc as tvpc

CPU = torch.device("cpu")
KEY = np.arange(8, dtype=np.uint32) * 3 + 1
NONCE = np.arange(3, dtype=np.uint32) + 7
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                  0xDEADBEEF, 2654435761, 0x9E3779B9, 0x01010101, 0xFFFF0000],
                 np.uint32)


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor with the same bits."""
    return torch.from_numpy(np.array(a))


def same(x, y) -> None:
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def rules_np(r: int, seed: int):
    return tuple(np.array(x) for x in jvpc.make_rules(r, seed=seed))


def tie_break_rules():
    return (np.asarray([0x0A000000, 0x0A010000, 0x0A010000], np.uint32),
            np.asarray([0xFF000000, 0xFFFF0000, 0xFFFF0000], np.uint32),
            np.asarray([True, False, True]))


TIE_HEADERS = np.asarray([[1, 0x0A010203, 2, 3, 4],     # /16 deny beats /8
                          [1, 0x0A220203, 2, 3, 4],     # only /8 allow hits
                          [1, 0x0B000000, 2, 3, 4]],    # no hit -> allow
                         np.uint32)


# ================================================================== _u32 ====
@pytest.fixture
def edge_pairs():
    a, b = np.meshgrid(EDGES, EDGES)
    rng = np.random.default_rng(0)
    a = np.concatenate([a.ravel(), rng.integers(0, 2 ** 32, 256,
                                                dtype=np.uint32)])
    b = np.concatenate([b.ravel(), rng.integers(0, 2 ** 32, 256,
                                                dtype=np.uint32)])
    return a, b


@pytest.mark.parametrize("op", ["add32", "mul32"])
def test_u32_binary_ops_wrap_like_numpy(op, edge_pairs):
    a, b = edge_pairs
    want = a + b if op == "add32" else a * b           # numpy u32 wraps
    got = getattr(_u32, op)(_u32.widen(t(a)), _u32.widen(t(b)))
    same(_u32.narrow(got), want)
    if op == "mul32":                                  # int constant operand
        for c in (2654435761, 0x9E3779B9, 0xFFFFFFFF):
            same(_u32.narrow(_u32.mul32(_u32.widen(t(a)), c)),
                 a * np.uint32(c))


@pytest.mark.parametrize("n", [1, 7, 8, 12, 16, 31])
def test_u32_shifts_and_rotates_like_numpy(n, edge_pairs):
    a, _ = edge_pairs
    w = _u32.widen(t(a))
    same(_u32.narrow(_u32.shl32(w, n)), a << np.uint32(n))
    same(_u32.narrow(_u32.rotl32(w, n)),
         (a << np.uint32(n)) | (a >> np.uint32(32 - n)))


def test_u32_popcount_where_and_arange(edge_pairs):
    a, b = edge_pairs
    bits = np.unpackbits(a.view(np.uint8).reshape(-1, 4), axis=1).sum(1)
    same(_u32.popcount32(_u32.widen(t(a))), bits)
    cond = torch.from_numpy(a > b)
    same(_u32.where32(cond, t(a), t(b)), np.where(a > b, a, b))
    same(_u32.where32(cond, t(a), 0), np.where(a > b, a, 0))
    start = 2 ** 32 - 3                                # wraps after 3
    want = np.uint32(start) + np.arange(6, dtype=np.uint32)
    same(_u32.narrow(_u32.arange32(start, 6, CPU)), want)
    same(_u32.narrow(_u32.arange32(torch.tensor(start), 6)), want)


# ============================================================== chacha20 ====
def test_rfc8439_vector_through_port_keystream():
    key = [0x03020100, 0x07060504, 0x0b0a0908, 0x0f0e0d0c,
           0x13121110, 0x17161514, 0x1b1a1918, 0x1f1e1d1c]
    nonce = [0x09000000, 0x4a000000, 0x00000000]
    ks = core.keystream(core.init_state(key, nonce, torch.tensor([1])))
    expect = [0xe4e7f110, 0x15593bd1, 0x1fdd0f50, 0xc47120a3,
              0xc7f4d1c7, 0x0368c033, 0x9aaa2204, 0x4e6cd4c3,
              0x466482d2, 0x09aa9f07, 0x05d7c214, 0xa2028bd9,
              0xd19c12b5, 0xb94e16de, 0xe883d0cb, 0x4e3c50a2]
    assert [int(ks[w][0]) for w in range(16)] == expect


def chacha_inputs(n: int):
    rng = np.random.default_rng(n)
    return (rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint32),
            rng.integers(0, 2 ** 32, 8, dtype=np.uint32),
            rng.integers(0, 2 ** 32, 3, dtype=np.uint32))


def test_chacha20_xor_matches_jax_kernel_across_counter_wrap():
    data, key, nonce = chacha_inputs(64)
    counter0 = 2 ** 32 - 5              # blocks 5.. wrap to counter 0..
    want = jax_chacha_kernel(jnp.asarray(data), jnp.asarray(key),
                             jnp.asarray(nonce), counter0=counter0,
                             interpret=True)
    got = chacha20_xor(t(data), t(key), t(nonce), counter0=counter0)
    assert got.dtype == torch.uint32
    same(got, want)
    same(chacha20_xor_plain(t(data), t(key), t(nonce), counter0), want)


@pytest.mark.parametrize("n,counter0", [(1, 1), (33, 7), (64, 2 ** 31)])
def test_chacha20_xor_matches_oracle_and_jnp_path(n, counter0):
    data, key, nonce = chacha_inputs(n)
    got = chacha20_xor(t(data), t(key), t(nonce), counter0=counter0)
    same(got, chacha20_xor_ref(data, key, nonce, counter0))
    same(tvpc.chacha20_xor(t(data), t(key), t(nonce), counter0), got)


def test_chacha20_explicit_ctr_matches_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2 ** 32, (16, 16), dtype=np.uint32)
    ctr = rng.integers(0, 2 ** 32, 16, dtype=np.uint32)
    want = jvpc.chacha20_xor_jnp(jnp.asarray(data), jnp.asarray(KEY),
                                 jnp.asarray(NONCE), ctr=jnp.asarray(ctr))
    same(tvpc.chacha20_xor(t(data), t(KEY), t(NONCE), ctr=t(ctr)), want)


def test_encrypt_bytes_round_trip_matches_jax():
    msg = b"SuperNIC disaggregates and consolidates network tasks." * 5
    jblocks, jn = jax_chacha_ops.bytes_to_blocks(msg)
    jct = jax_chacha_ops.encrypt(jblocks, jnp.asarray(KEY),
                                 jnp.asarray(NONCE))
    blocks, n = chacha_ops.bytes_to_blocks(msg, device="cpu")
    assert n == jn and blocks.dtype == torch.uint32
    same(blocks, jblocks)
    ct = chacha_ops.encrypt(blocks, t(KEY), t(NONCE))
    same(ct, jct)
    assert chacha_ops.blocks_to_bytes(ct, n) == \
        jax_chacha_ops.blocks_to_bytes(jct, jn) != msg
    back = chacha_ops.encrypt(ct, t(KEY), t(NONCE))
    assert chacha_ops.blocks_to_bytes(back, n) == msg


# ================================================================ chain =====
@pytest.mark.parametrize("seed", [0, 2, 7])
def test_make_rules_and_packets_identical_bits(seed):
    for got, want in zip(tvpc.make_rules(32, seed=seed, device="cpu"),
                         jvpc.make_rules(32, seed=seed)):
        same(got, want)
    h, p = tvpc.make_packets(17, seed=seed, device="cpu")
    jh, jp = jvpc.make_packets(17, seed=seed)
    assert h.dtype == p.dtype == torch.uint32
    same(h, jh)
    same(p, jp)


@pytest.mark.parametrize("n", [1, 9, 257])
@pytest.mark.parametrize("r", [1, 32, 300])
def test_firewall_and_nat_match_jax(n, r):
    rules = rules_np(r, seed=r)
    h, _ = jvpc.make_packets(n, seed=n)
    same(tvpc.firewall(t(h), tuple(t(x) for x in rules)),
         jvpc.firewall(h, rules))
    same(tvpc.nat_rewrite(t(h), 0x0A000001), jvpc.nat_rewrite(h, 0x0A000001))


@pytest.mark.parametrize("n,r", [(1, 1), (9, 32), (257, 300)])
def test_vpc_chain_matches_jax(n, r):
    rules = rules_np(r, seed=r)
    trules = tuple(t(x) for x in rules)
    h, p = jvpc.make_packets(n, seed=n)
    th, tp = t(h), t(p)
    got = tvpc.vpc_chain(th, tp, trules, t(KEY), t(NONCE))
    want = jvpc.vpc_chain(h, p, rules, jnp.asarray(KEY), jnp.asarray(NONCE))
    for g, w in zip(got, want):
        same(g, w)


def test_firewall_chunks_and_tie_break(monkeypatch):
    monkeypatch.setattr(tvpc, "_FW_CHUNK_ELEMS", 64)   # many row chunks
    rules = rules_np(300, seed=4)
    h, _ = jvpc.make_packets(257, seed=4)
    same(tvpc.firewall(t(h), tuple(t(x) for x in rules)),
         jvpc.firewall(h, rules))
    tie = tie_break_rules()
    want = jvpc.firewall(jnp.asarray(TIE_HEADERS), tie)
    same(want, [False, True, True])
    same(tvpc.firewall(t(TIE_HEADERS), tuple(t(x) for x in tie)), want)


# =========================================================== vpc_datapath ===
@pytest.mark.parametrize("n,explicit_ctr", [(9, False), (64, True)])
def test_vpc_datapath_matches_jax_interpret(n, explicit_ctr):
    rules = rules_np(32, seed=2)
    h, p = jvpc.make_packets(n, seed=n + 1)
    ctr = np.random.default_rng(n).integers(0, 2 ** 32, n, dtype=np.uint32) \
        if explicit_ctr else None
    want = jax_vpc_datapath(h, p, rules, jnp.asarray(KEY),
                            jnp.asarray(NONCE),
                            ctr=None if ctr is None else jnp.asarray(ctr),
                            interpret=True)
    trules = tuple(t(x) for x in rules)
    got = vpc_datapath(t(h), t(p), trules, t(KEY), t(NONCE),
                       ctr=None if ctr is None else t(ctr))
    ref = vpc_datapath_ref(t(h), t(p), trules, t(KEY), t(NONCE),
                           ctr=None if ctr is None else t(ctr))
    for g, r_, w in zip(got, ref, want):
        same(g, w)
        same(r_, w)


def test_vpc_datapath_tensor_counter0_wraps_like_jax():
    rules = rules_np(32, seed=5)
    h, p = jvpc.make_packets(9, seed=5)
    c0 = 2 ** 32 - 3
    want = jvpc.vpc_chain(h, p, rules, jnp.asarray(KEY), jnp.asarray(NONCE),
                          nat_ip=0x0B000002, counter0=c0)
    got = vpc_datapath(t(h), t(p), tuple(t(x) for x in rules), t(KEY),
                       t(NONCE), counter0=torch.tensor(c0),
                       nat_ip=torch.tensor(0x0B000002))
    for g, w in zip(got, want):
        same(g, w)


def test_vpc_datapath_tie_break_and_empty_batch():
    tie = tie_break_rules()
    p = np.zeros((3, 16), np.uint32)
    allow, _, _ = vpc_datapath(t(TIE_HEADERS), t(p), tuple(t(x) for x in tie),
                               t(KEY), t(NONCE))
    same(allow, [False, True, True])
    h0 = torch.zeros((0, 5), dtype=torch.uint32)
    p0 = torch.zeros((0, 16), dtype=torch.uint32)
    a, nh, ct = vpc_datapath(h0, p0, tuple(t(x) for x in tie), t(KEY),
                             t(NONCE))
    ja, jh, jc = jax_vpc_datapath(jnp.zeros((0, 5), jnp.uint32),
                                  jnp.zeros((0, 16), jnp.uint32), tie,
                                  jnp.asarray(KEY), jnp.asarray(NONCE),
                                  interpret=True)
    assert a.shape == ja.shape == (0,) and a.dtype == torch.bool
    assert nh.shape == jh.shape and ct.shape == jc.shape


def test_vpc_plain_fused_matches_ref_across_chunks(monkeypatch):
    monkeypatch.setattr(vpc_kernel, "_CHUNK_ELEMS", 300 * 40)
    rules = tuple(t(x) for x in rules_np(300, seed=6))
    h, p = tvpc.make_packets(257, seed=6, device="cpu")
    ctr = t(np.random.default_rng(6).integers(0, 2 ** 32, 257,
                                              dtype=np.uint32))
    got = vpc_kernel.vpc_datapath_plain(
        h, p, ctr, rule_table(rules, CPU), t(KEY), t(NONCE),
        torch.tensor([0x0A000001], dtype=torch.int64).to(torch.uint32),
        0x9e3779b9)
    for g, w in zip(got, vpc_datapath_ref(h, p, rules, t(KEY), t(NONCE),
                                          ctr=ctr)):
        assert torch.equal(g, w)


def test_rule_table_and_smem_bytes():
    rules = rules_np(32, seed=2)
    table = rule_table(tuple(t(x) for x in rules), CPU)
    assert table.shape == (32, 4) and table.dtype == torch.uint32
    same(table[:, 0], rules[0])
    same(table[:, 1], rules[1])
    same(table[:, 2], np.unpackbits(rules[1].view(np.uint8).reshape(-1, 4),
                                    axis=1).sum(1))
    same(table[:, 3], rules[2].astype(np.uint32))
    assert chacha_ops.smem_tile_bytes() == 0
    from repro_torch.kernels.vpc_datapath.ops import smem_tile_bytes
    assert smem_tile_bytes() == vpc_kernel.RULE_CHUNK * 16


# ====================================================== wrapper contract ====
def test_wrappers_raise_on_devices_without_a_kernel():
    meta = torch.empty((4, 16), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        chacha20_xor(meta, t(KEY), t(NONCE))
    with pytest.raises(ValueError, match="no kernel"):
        vpc_kernel.vpc_datapath_fused(
            torch.empty((4, 5), dtype=torch.uint32, device="meta"), meta,
            None, None, None, None, None, 0)


def test_require_rejects_what_the_kernels_do_not_take():
    good = torch.zeros((4, 16), dtype=torch.uint32)
    _build.require(good, "x", (-1, 16), CPU, align=16)
    with pytest.raises(TypeError):
        _build.require(good.to(torch.int32), "x", (-1, 16), CPU)
    with pytest.raises(ValueError, match="shape"):
        _build.require(good, "x", (-1, 5), CPU)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(good.t(), "x", (16, -1), CPU)
    with pytest.raises(ValueError, match="expected meta"):
        _build.require(good, "x", (-1, 16), torch.device("meta"))
    with pytest.raises(ValueError, match="aligned"):
        _build.require(good.reshape(-1)[1:5], "x", (4,), CPU, align=16)


# ================================================= kernels on the card ====
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 511, 513])
def test_chacha20_cuda_matches_plain(cuda_device, n):
    from repro_torch.kernels.chacha20.kernel import chacha20_xor_cuda
    rng = np.random.default_rng(n)
    data = t(rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint32)).to(
        cuda_device)
    key, nonce = t(KEY).to(cuda_device), t(NONCE).to(cuda_device)
    before = chacha20_xor_cuda.launches
    got = chacha20_xor(data, key, nonce, counter0=2 ** 32 - 100)
    assert chacha20_xor_cuda.launches == before + 1
    assert torch.equal(got, chacha20_xor_plain(data, key, nonce,
                                               2 ** 32 - 100))


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(1, 1), (255, 300), (257, 5000)])
def test_vpc_datapath_cuda_matches_plain(cuda_device, n, r):
    rules = tuple(x.to(cuda_device) for x in
                  tvpc.make_rules(r, seed=r, device="cpu"))
    h, p = tvpc.make_packets(n, seed=n, device=cuda_device)
    before = vpc_kernel.vpc_datapath_cuda.launches
    got = vpc_datapath(h, p, rules, t(KEY).to(cuda_device),
                       t(NONCE).to(cuda_device))
    assert vpc_kernel.vpc_datapath_cuda.launches == before + 1
    want = vpc_datapath_ref(h, p, rules, t(KEY).to(cuda_device),
                            t(NONCE).to(cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
