#!/usr/bin/env python3
"""Before and after on one card: the port's ``moe_gmm`` and
``flash_attention`` CUDA kernels against an earlier version of their
sources, at the shapes the serving and training paths give them.

    mkdir -p build/ab_old
    git show <commit>:src/repro_torch/csrc/moe_gmm.cu > build/ab_old/moe_gmm.cu
    git show <commit>:src/repro_torch/csrc/flash_attention.cu \\
        > build/ab_old/flash_attention.cu
    python3 tools/kernel_ab.py --old build/ab_old

Builds both versions of each source with the port's ``nvcc`` flags into
``build/kernel_ab/`` (one ``nvcc`` per library, all started together),
holds both against the plain PyTorch versions (the reference's tolerances,
``chip_smoke.close``), and times raw launches of the C entry points with
CUDA events in the order old, new, new, old.  Beside them: the bound
(``chip_smoke.Card``), and the PyTorch calls that compute the same
function (``torch.bmm`` on bf16 weights; ``w.to(torch.bfloat16)`` then
``torch.bmm``, two calls, with the cast inside the timing;
``scaled_dot_product_attention``).  Prints the ``nvidia-smi`` name and power limit, one JSON line per shape,
and writes them all to ``chiprun_out/kernel_ab.json``.  Needs a CUDA
device; imports nothing of JAX.
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

SOURCES = ("moe_gmm", "flash_attention")
ENTRY = {"moe_gmm": "moe_gmm_launch",
         "flash_attention": "flash_attention_launch"}
#: launches a timing averages over
REPS = 10
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


def build(old_dir: Path) -> dict:
    """Compile old and new versions of both sources; return the loaded
    libraries {(version, source): CDLL} and ptxas's register lines."""
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for version, src_dir in (("old", old_dir), ("new", _build.CSRC)):
        for name in SOURCES:
            lib = out_dir / f"lib{name}_{version}.so"
            procs[version, name] = (lib, subprocess.Popen(
                _build.command(nvcc, src_dir / f"{name}.cu", lib),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        ptxas["/".join(key)] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]
        cdll = ctypes.CDLL(str(lib))
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


def main() -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, required=True,
                   help="directory holding the earlier moe_gmm.cu and "
                        "flash_attention.cu")
    a = p.parse_args()
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
    built = build(a.old)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": built["ptxas"]})
    for shape in FA_SHAPES:
        emit(fa_case(card, built["libs"], *shape, REPS))
        cs.free_device()
    for shape in GMM_SHAPES:
        emit(gmm_case(card, built["libs"], *shape, REPS))
        cs.free_device()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(
        {"card": card.smi, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
