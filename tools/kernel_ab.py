#!/usr/bin/env python3
"""Before and after on one card: the port's ``moe_gmm``,
``flash_attention``, ``rwkv6_wkv``, ``mamba_ssm``, ``quantize_int8`` and
``vpc_datapath`` CUDA kernels against an earlier version of their sources,
at the shapes the serving, training and datapath paths give them.

    mkdir -p build/ab_old
    for f in quantize.cu vpc_datapath.cu chacha20.cuh; do
        git show <commit>:src/repro_torch/csrc/$f > build/ab_old/$f
    done
    python3 tools/kernel_ab.py --old build/ab_old

The directory may hold any of ``moe_gmm.cu``, ``flash_attention.cu``,
``rwkv6_scan.cu``, ``mamba_scan.cu``, ``quantize.cu`` and
``vpc_datapath.cu`` (with the ``chacha20.cuh`` that the last includes; each
version is built with ``-I`` on its own directory); the kernels of the
sources it holds are compared.  Builds both versions of each with the
port's ``nvcc`` flags into ``build/kernel_ab/`` (one ``nvcc`` per library,
all started together), holds both against the plain PyTorch versions (the
reference's tolerances: ``chip_smoke.close``, ``chip_smoke.wkv_close``;
``torch.equal`` for the integer and quantize kernels), and times raw
launches of the C entry points with CUDA events in the order old, new,
new, old.  Beside them: the bound (``chip_smoke.Card``); the PyTorch calls
that compute the same function (``torch.bmm`` on bf16 weights;
``w.to(torch.bfloat16)`` then ``torch.bmm``, two calls, with the cast
inside the timing; ``scaled_dot_product_attention``); and at the scans'
decode shapes and the datapath's an empty kernel of each version's launch
shape, timed the same way, the floor of a raw launch paced by the host.
Quantize runs at the train step's row sizes (each version's amax scratch
zeroed inside its timing), over rows of 4-64 M elements (where the second
read leaves L2), and sums a train step's launches
(``quantize_int8_ms_per_step``).  Prints the ``nvidia-smi`` name and power
limit, one JSON line per shape, and writes them all to
``chiprun_out/kernel_ab.json``.  Needs a CUDA device; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SOURCES = ("moe_gmm", "flash_attention", "rwkv6_scan", "mamba_scan",
           "quantize", "vpc_datapath")
ENTRY = {"moe_gmm": "moe_gmm_launch",
         "flash_attention": "flash_attention_launch",
         "rwkv6_scan": "rwkv6_wkv_launch", "mamba_scan": "mamba_ssm_launch",
         "quantize": "quantize_int8_launch",
         "vpc_datapath": "vpc_datapath_launch"}
#: launches a timing averages over, and at the scans' one-step shapes
REPS = 10
DECODE_REPS = 100
#: (name, E, M, d, f, w dtype): serve_hybrid's expert launches (Jamba at
#: full width: 16 experts, d 4,096, f 14,336; 448 capacity rows at prefill,
#: 4 at a decode step) with the model's f32 weights, and the bf16-weight
#: route at the same shapes
GMM_SHAPES = (("prefill_gate", 16, 448, 4096, 14336, "float32"),
              ("prefill_down", 16, 448, 14336, 4096, "float32"),
              ("decode_gate", 16, 4, 4096, 14336, "float32"),
              ("prefill_gate_bf16w", 16, 448, 4096, 14336, "bfloat16"),
              ("decode_gate_bf16w", 16, 4, 4096, 14336, "bfloat16"))
#: (name, B, S, H, Kv, hd, lse): serve's prefill group (qwen3-8b), the
#: train step (qwen3-8b, 1 x 4,096, with the LSE), each also with the other
#: instantiation, and serve_moe's head dim (granite, 16 / 8 heads of 64)
FA_SHAPES = (("serve", 2, 1237, 32, 8, 128, False),
             ("serve_lse", 2, 1237, 32, 8, 128, True),
             ("train_lse", 1, 4096, 32, 8, 128, True),
             ("train", 1, 4096, 32, 8, 128, False),
             ("serve_hd64", 2, 1237, 16, 8, 64, False))
#: (name, B, S, H, hd, carried state): serve_rwkv's longest prefill group
#: (rwkv6-3b, 40 heads of 64) from a zero state, and a decode step of that
#: batch from a carried state
WKV_SHAPES = (("prefill", 2, 1421, 40, 64, False),
              ("decode", 2, 1, 40, 64, True))
#: (name, B, S, di, carried state): serve_hybrid's (Jamba at full width,
#: di 8,192, d_state 16), likewise
SCAN_SHAPES = (("prefill", 2, 1421, 8192, False),
               ("decode", 2, 1, 8192, True))
#: the train step's quantize launches (qwen3-8b at full width, 8 layers;
#: each f32 gradient one row): D -> launches a step.  The embedding and
#: the head (151,936 x 4,096), 24 MLP weights (4,096 x 12,288), 16 of
#: q/o (4,096 x 4,096) and 16 of k/v (4,096 x 1,024), 17 norms of 4,096
#: and 16 q/k norms of 128: 91 tensors
TRAIN_ROWS = {622329856: 2, 50331648: 24, 16777216: 16, 4194304: 16,
              4096: 17, 128: 16}
#: rows (1, D) f32 between them, to show where the second read leaves L2
L2_ROWS = (8 << 20, 32 << 20, 64 << 20)
#: the datapath's raw launches: (N, R), the main path's bucket and a
#: larger batch where the host's launch floor matters less
VPC_SHAPES = ((131072, 300), (1048576, 300))
#: an empty kernel, for the floor of a raw launch at a given launch shape
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(unsigned gx, unsigned gy, unsigned threads,
                            void* stream) {
  empty_kernel<<<dim3(gx, gy), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def build(old_dir: Path, sources: list) -> dict:
    """Compile old and new versions of ``sources`` and the empty kernel;
    return the loaded libraries {(version, source): CDLL}, the empty
    kernel's launcher and ptxas's register lines."""
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "empty.cu").write_text(EMPTY_CU)
    jobs = {("empty", "empty"): (out_dir / "empty.cu",
                                 out_dir / "libempty.so")}
    for version, src_dir in (("old", old_dir), ("new", _build.CSRC)):
        for name in sources:
            jobs[version, name] = (src_dir / f"{name}.cu",
                                   out_dir / f"lib{name}_{version}.so")
    procs = {key: (lib, subprocess.Popen(
        [*_build.command(nvcc, src, lib), f"-I{src.parent}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for key, (src, lib) in jobs.items()}
    libs, ptxas = {}, {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        ptxas["/".join(key)] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]
        cdll = ctypes.CDLL(str(lib))
        if key[0] == "empty":
            cdll.empty_launch.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                          ctypes.c_uint, ctypes.c_void_p]
            cdll.empty_launch.restype = ctypes.c_int
        else:
            fn = getattr(cdll, ENTRY[key[1]])
            fn.argtypes, fn.restype = _build.SIGNATURES[key[1]][ENTRY[key[1]]]
        libs[key] = cdll
    return {"libs": libs, "ptxas": ptxas}


def launcher(cdll, entry: str, args: list, keep):
    from repro_torch.kernels import _build
    fn = getattr(cdll, entry)

    def launch():
        _build.check(fn(*args), entry)
    launch.keep = keep
    return launch


def gmm_launch(cdll, x, w):
    import torch
    E, M, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, M, f), dtype=x.dtype, device=x.device)
    code = {torch.float32: 0, torch.bfloat16: 1}
    return launcher(cdll, "moe_gmm_launch", [
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, d, f,
        code[x.dtype], code[w.dtype],
        torch.cuda.current_stream().cuda_stream], out)


def fa_launch(cdll, q, k, v, lse: bool):
    import torch
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    ls = torch.empty((B, S, H), dtype=torch.float32, device=q.device) \
        if lse else None
    return launcher(cdll, "flash_attention_launch", [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if ls is None else ls.data_ptr(), B, S, H, k.shape[2], hd, 1,
        1, torch.cuda.current_stream().cuda_stream], (out, ls))


def turns(fns: dict, reps: int) -> dict:
    """ms per launch of each of old and new, timed old, new, new, old."""
    times = {"old": [], "new": []}
    for version in ("old", "new", "new", "old"):
        times[version].append(cs.cuda_ms(fns[version], reps))
    return times


def gmm_case(card, libs, name, E, M, d, f, wd, reps) -> dict:
    import torch

    from repro_torch.kernels.moe_gmm import moe_gmm_ref
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((E, M, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device="cuda")
         * d ** -0.5).to(getattr(torch, wd))
    want = moe_gmm_ref(x, w)
    fns = {v: gmm_launch(libs[v, "moe_gmm"], x, w) for v in ("old", "new")}
    errs = {}
    for v, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        errs[v] = cs.close(fn.keep, want, f"moe_gmm {name} ({v})")
    bound, by, nbytes, flops = cs.gmm_bound(card, x, w)
    rec = {"kernel": "moe_gmm", "shape": name, "E": E, "M": M, "d": d,
           "f": f, "x": "torch.bfloat16", "w": str(w.dtype),
           "max_abs_err": errs, "ms": turns(fns, reps), "bound_ms": bound,
           "bound_by": by, "bytes": nbytes, "flops": flops}
    if w.dtype == torch.bfloat16:
        rec["library_ms"] = cs.cuda_ms(lambda: torch.bmm(x, w), reps)
        rec["library"] = "torch.bmm(x, w), the same bf16 weights"
    else:
        rec["two_calls_ms"] = cs.cuda_ms(
            lambda: torch.bmm(x, w.to(torch.bfloat16)), reps)
        rec["two_calls"] = ("w.to(torch.bfloat16) then torch.bmm, the cast "
                            "inside the timing")
    del x, w, want, fns
    return rec


def fa_case(card, libs, name, B, S, H, Kv, hd, lse, reps) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    rng = cs.np.random.default_rng(17)
    q, k, v = cs.fa_inputs(rng, B, S, H, Kv, hd, "bfloat16", "cuda")
    want, want_lse = attention_ref(q, k, v, True, return_lse=True)
    fns = {ver: fa_launch(libs[ver, "flash_attention"], q, k, v, lse)
           for ver in ("old", "new")}
    errs = {}
    for ver, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        out, ls = fn.keep
        errs[ver] = cs.close(out, want, f"flash {name} ({ver})")
        if lse:
            errs[ver + "_lse"] = cs.close(ls, want_lse,
                                          f"flash {name} lse ({ver})", 3e-2)
    flops = 4 * B * H * hd * S * (S + 1) / 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + \
        (B * S * H * 4 if lse else 0)
    bound, by = card.bound(nbytes, flops, cs.PEAK_FLOPS[str(q.dtype)])
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return {"kernel": "flash_attention", "shape": name, "B": B, "S": S,
            "H": H, "Kv": Kv, "hd": hd, "lse": lse, "causal": True,
            "max_abs_err": errs, "ms": turns(fns, reps), "bound_ms": bound,
            "bound_by": by, "flops": flops,
            "library_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps),
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on (B, H, S, hd) copies"}


def empty_launch(libs, grid: tuple) -> object:
    """A raw launch of the empty kernel at ``grid`` = (x, y, threads)."""
    import torch
    return launcher(libs["empty", "empty"], "empty_launch",
                    [*grid, torch.cuda.current_stream().cuda_stream], None)


def wkv_grid(version: str, B: int, H: int, hd: int, sms: int) -> tuple:
    """(grid x, grid y, threads) of a WKV launch: the first design ("old"),
    one block of hd threads a (batch, head) pair; this one, a pair's
    columns over 2, 4 or 8 blocks of compute warps and a staging warp (the
    rule of ``rwkv6_scan.cu``'s ``launch``)."""
    if version == "old":
        return B * H, 1, hd
    slots = 32 // (hd // (8 if hd == 64 else 4))
    parts = 2
    while parts < 8 and B * H * parts < 4 * sms and hd // (2 * parts) >= slots:
        parts *= 2
    return B * H, parts, hd // parts // slots * 32 + 32


def scan_grid(version: str, B: int, di: int) -> tuple:
    """(grid x, grid y, threads) of a scan launch: 64 channels a block,
    one thread a channel (the first design, "old") or four (this one)."""
    return -(-di // 64), B, 64 if version == "old" else 256


def wkv_launch(cdll, a: dict):
    import torch
    B, S, H, hd = a["r"].shape
    y = torch.empty_like(a["r"])
    st = torch.empty((B, H, hd, hd), dtype=torch.float32, device="cuda")
    s0 = a["state0"]
    return launcher(cdll, "rwkv6_wkv_launch", [
        a["r"].data_ptr(), a["k"].data_ptr(), a["v"].data_ptr(),
        a["w"].data_ptr(), a["u"].data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), st.data_ptr(),
        B, S, H, hd, torch.cuda.current_stream().cuda_stream], (y, st))


def scan_launch(cdll, a: dict):
    import torch
    B, S, di = a["x"].shape
    y = torch.empty_like(a["x"])
    h = torch.empty((B, di, cs.SCAN_DS), dtype=torch.float32, device="cuda")
    h0 = a["h0"]
    return launcher(cdll, "mamba_ssm_launch", [
        a["x"].data_ptr(), a["dt"].data_ptr(), a["Bmat"].data_ptr(),
        a["Cmat"].data_ptr(), a["A"].data_ptr(), a["D"].data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        B, S, di, cs.SCAN_DS, torch.cuda.current_stream().cuda_stream],
        (y, h))


def scan_cases(card, libs, kind: str, shape: tuple) -> dict:
    """One shape of ``rwkv6_wkv`` (``kind`` "wkv") or ``mamba_ssm``
    ("scan"): both versions against the plain version, timed in turns;
    at S = 1 also the empty kernel at each version's launch shape."""
    import torch

    from repro_torch.kernels.mamba_scan import mamba_ssm_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_ref
    gen = torch.Generator(device="cuda").manual_seed(18)
    if kind == "wkv":
        name, B, S, H, hd, state = shape
        a = cs.wkv_inputs(gen, B, S, H, hd, "cuda", state)
        want = rwkv6_wkv_ref(*(a[k] for k in "rkvwu"), a["state0"])
        fns = {v: wkv_launch(libs[v, "rwkv6_scan"], a)
               for v in ("old", "new")}
        held = lambda fn, v: cs.wkv_close(                    # noqa: E731
            *fn.keep, *want, f"rwkv6_wkv {name} ({v})")
        bound, by, nbytes, ops = cs.wkv_bound(card, B, S, H, hd, state)
        grids = {v: wkv_grid(v, B, H, hd, card.sms) for v in fns}
        rec = {"kernel": "rwkv6_wkv", "shape": name, "B": B, "S": S,
               "H": H, "hd": hd, "state0": state, "flops": ops}
    else:
        name, B, S, di, state = shape
        a = cs.scan_inputs(gen, B, S, di, "cuda", state)
        want = mamba_ssm_ref(**a)
        fns = {v: scan_launch(libs[v, "mamba_scan"], a)
               for v in ("old", "new")}
        held = lambda fn, v: max(                             # noqa: E731
            cs.close(got, w, f"mamba_ssm {name} ({v})", cs.SCAN_TOL)
            for got, w in zip(fn.keep, want))
        bound, by, nbytes, steps = cs.scan_bound(card, B, S, di, state)
        grids = {v: scan_grid(v, B, di) for v in fns}
        rec = {"kernel": "mamba_ssm", "shape": name, "B": B, "S": S,
               "di": di, "d_state": cs.SCAN_DS, "h0": state,
               "exps": steps * cs.SCAN_DS}
    errs = {}
    for v, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        errs[v] = held(fn, v)
    reps = DECODE_REPS if S == 1 else REPS
    rec.update({"max_abs_err": errs, "ms": turns(fns, reps),
                "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                "launch_shape": grids, "library_ms": None,
                "library": "none: no single PyTorch call"})
    if S == 1:
        rec["empty_kernel_ms"] = turns(
            {v: empty_launch(libs, g) for v, g in grids.items()}, reps)
    return rec


def quant_launch(cdll, x):
    """A raw quantize launch on fixed buffers that zeroes its amax scratch
    first (both inside a timing, as the wrapper does them)."""
    import torch
    R, D = x.shape
    q = torch.empty((R, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    amax = torch.zeros((R,), dtype=torch.int32, device=x.device)
    launch = launcher(cdll, "quantize_int8_launch", [
        x.data_ptr(), 0 if x.dtype == torch.float32 else 1, q.data_ptr(),
        scale.data_ptr(), amax.data_ptr(), R, D,
        torch.cuda.current_stream().cuda_stream], (q, scale))

    def run():
        amax.zero_()
        launch()
    run.keep = launch.keep
    return run


def quant_case(card, libs, D: int) -> dict:
    """One (1, D) f32 row: both versions bit for bit against the plain
    version, timed in turns."""
    import torch

    from repro_torch.kernels.quantize import quantize_int8_ref
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn((1, D), generator=gen, device="cuda")
    want = quantize_int8_ref(x)
    fns = {v: quant_launch(libs[v, "quantize"], x) for v in ("old", "new")}
    for v, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        cs.expect(all(torch.equal(a, b) for a, b in zip(fn.keep, want)),
                  f"quantize_int8 D={D} ({v}) differs from plain")
    del want
    reps = 10 if D > 1 << 27 else 50 if D > 1 << 20 else 200
    bound, by = card.bound(5 * D + 4, 0)
    return {"kernel": "quantize_int8", "shape": {"R": 1, "D": D},
            "x": "torch.float32", "bit_exact": True, "ms": turns(fns, reps),
            "bound_ms": bound, "bound_by": by, "bytes": 5 * D + 4,
            "launches_per_train_step": TRAIN_ROWS.get(D, 0),
            "library_ms": None, "library": "none: no single PyTorch call"}


def quant_special(libs) -> dict:
    """Rows holding an inf or a NaN (an inf or NaN scale, every q 0 in the
    plain version): each version against the plain version, the new one
    required bit for bit, the old one's differing elements counted."""
    import torch

    from repro_torch.kernels.quantize import quantize_int8_ref
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((4, 40000), generator=gen, device="cuda") * 3
    x[0, 7], x[0, 100], x[1, 50], x[2, 9] = (float("inf"), float("-inf"),
                                             float("nan"), float("inf"))
    want = quantize_int8_ref(x)
    rec = {"kernel": "quantize_int8", "shape": {"R": 4, "D": 40000,
                                                "rows": "inf, nan"},
           "x": "torch.float32", "bit_exact": {}, "q_differing": {}}
    for v in ("old", "new"):
        fn = quant_launch(libs[v, "quantize"], x)
        fn()
        torch.cuda.synchronize()
        q, s = fn.keep
        rec["bit_exact"][v] = torch.equal(q, want[0]) and cs.same_values(
            s, want[1])
        rec["q_differing"][v] = int((q != want[0]).sum())
    cs.expect(rec["bit_exact"]["new"],
              "quantize_int8 rows with inf or nan (new) differ from plain")
    return rec


def quant_step(records: list) -> dict:
    """A train step's quantize device ms for each version: its launches at
    each row size times the mean raw-launch ms there."""
    ms = {r["shape"]["D"]: r["ms"] for r in records
          if r.get("kernel") == "quantize_int8" and "ms" in r}
    return {"kernel": "quantize_int8", "shape": "train_step",
            "rows": TRAIN_ROWS,
            "ms_per_step": {v: sum(n * sum(ms[D][v]) / len(ms[D][v])
                                   for D, n in TRAIN_ROWS.items())
                            for v in ("old", "new")}}


def vpc_launch(cdll, a: dict):
    import torch
    n = a["headers"].shape[0]
    outs = (torch.empty(n, dtype=torch.bool, device="cuda"),
            torch.empty_like(a["headers"]), torch.empty_like(a["payload"]))
    return launcher(cdll, "vpc_datapath_launch", [
        a["headers"].data_ptr(), a["payload"].data_ptr(), a["ctr"].data_ptr(),
        a["rule_table"].data_ptr(), a["key"].data_ptr(), a["nonce"].data_ptr(),
        a["nat_ip"].data_ptr(), a["salt"], outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), n, a["rule_table"].shape[0],
        torch.cuda.current_stream().cuda_stream], outs)


def vpc_grid(version: str, n: int) -> tuple:
    """(grid x, grid y, threads) of a datapath launch: one thread a packet
    in blocks of 256 (the first design, "old"), or blocks of 128 threads
    with two packets a thread (this one)."""
    return -(-n // 256), 1, 256 if version == "old" else 128


def vpc_case(card, libs, n: int, r: int) -> dict:
    """One (N, R): both versions bit for bit against the plain version,
    timed in turns beside an empty kernel of each launch shape."""
    import torch

    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_plain
    a = cs.vpc_inputs(cs.np.random.default_rng(20), n, r,
                      torch.device("cuda"))
    want = vpc_datapath_plain(**a)
    fns = {v: vpc_launch(libs[v, "vpc_datapath"], a) for v in ("old", "new")}
    for v, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        cs.expect(cs.same_triple(fn.keep, want),
                  f"vpc_datapath N={n} R={r} ({v}) differs from plain")
    allowed = int(want[0].sum())
    bound, by, nbytes, ops = cs.vpc_bound(card, n, r, allowed)
    grids = {v: vpc_grid(v, n) for v in fns}
    return {"kernel": "vpc_datapath", "shape": {"N": n, "R": r,
                                                "allowed": allowed},
            "bit_exact": True, "ms": turns(fns, 200), "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "int_ops": ops,
            "launch_shape": grids,
            "empty_kernel_ms": turns({v: empty_launch(libs, g)
                                      for v, g in grids.items()}, 200),
            "library_ms": None, "library": "none: no single PyTorch call"}


def main() -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, required=True,
                   help="directory holding earlier versions of any of "
                        + ", ".join(f"{s}.cu" for s in SOURCES))
    a = p.parse_args()
    sources = [s for s in SOURCES if (a.old / f"{s}.cu").exists()]
    if not sources:
        print(f"kernel_ab: {a.old} holds none of {SOURCES}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.Card()
    print(card.smi, flush=True)
    records = []

    def emit(rec):
        records.append(rec)
        cs.emit(rec)

    t0 = time.perf_counter()
    built = build(a.old, sources)
    libs = built["libs"]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sources, "ptxas": built["ptxas"]})
    cases = []
    if "flash_attention" in sources:
        cases += [lambda s=s: fa_case(card, libs, *s, REPS)
                  for s in FA_SHAPES]
    if "moe_gmm" in sources:
        cases += [lambda s=s: gmm_case(card, libs, *s, REPS)
                  for s in GMM_SHAPES]
    if "rwkv6_scan" in sources:
        cases += [lambda s=s: scan_cases(card, libs, "wkv", s)
                  for s in WKV_SHAPES]
    if "mamba_scan" in sources:
        cases += [lambda s=s: scan_cases(card, libs, "scan", s)
                  for s in SCAN_SHAPES]
    if "quantize" in sources:
        cases += [lambda D=D: quant_case(card, libs, D)
                  for D in sorted({*TRAIN_ROWS, *L2_ROWS})]
        cases.append(lambda: quant_step(records))
        cases.append(lambda: quant_special(libs))
    if "vpc_datapath" in sources:
        cases += [lambda s=s: vpc_case(card, libs, *s) for s in VPC_SHAPES]
    for case in cases:
        emit(case())
        cs.free_device()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(
        {"card": card.smi, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
