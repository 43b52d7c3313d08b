"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes`.  All
sources are compiled at once, in parallel, at the first CUDA use, into
``build/repro_torch_kernels/`` at the root of the checkout; a library is
rebuilt when the hash of the sources and flags changes.  Nothing here runs
at import time: the package imports where there is no ``nvcc``.

A failed build raises with ``nvcc``'s output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _U32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_int)

#: C entry points per source: name -> (argtypes, restype)
SIGNATURES: dict[str, dict[str, tuple[list, type]]] = {
    "chacha20": {
        "chacha20_xor_launch": ([_P, _P, _P, _P, _U32, _I64, _P], _INT),
    },
    "vpc_datapath": {
        "vpc_datapath_launch": (
            [_P, _P, _P, _P, _P, _P, _P, _U32, _P, _P, _P, _I64, _I64, _P],
            _INT),
        "vpc_datapath_smem_bytes": ([], _I64),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: wall seconds of the last build and nvcc's output per source (ptxas
#: register and shared-memory counts), for the chip smoke run to report
build_seconds: float = 0.0
build_log: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` that is not built for the current sources
    (one ``nvcc`` per source, all started together) and load them all."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        nvcc = _nvcc()
        digest = _digest(nvcc)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        outs = {}
        for name in SIGNATURES:
            out = BUILD_DIR / f"lib{name}-{digest}.so"
            outs[name] = out
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, outs[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        build_seconds = time.perf_counter() - t0
        for name, entries in SIGNATURES.items():
            lib = ctypes.CDLL(str(outs[name]))
            for fn, (argtypes, restype) in entries.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def require(t, name: str, shape: tuple, device, align: int = 4) -> None:
    """Raise unless ``t`` is a contiguous ``torch.uint32`` tensor of
    ``shape`` (``-1`` is any extent) on ``device``, with its data
    ``align``-byte aligned."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.uint32:
        raise TypeError(f"{name} must be torch.uint32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s != -1 and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('N' if s == -1 else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
