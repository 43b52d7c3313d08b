"""Kernel-text and buffer tools: the JAX package's HLO inspection for a
CUDA build.

``python -m repro_torch.analysis hlo grep KERNEL PATTERN [LIMIT]``
``python -m repro_torch.analysis hlo buffers ARCH SHAPE [MIN_BYTES]
[--layers N]``

A CUDA build has no HLO.  What stands in for it:

  - the compiled program's text is the SASS of one built kernel library,
    ``cuobjdump -sass build/repro_torch_kernels/lib<KERNEL>-<digest>.so``
    (the library ``kernels._build`` builds for the current sources);
    :func:`grep_lines` greps it as it grepped HLO;
  - the buffer assignment is the caching allocator's record of one step of
    the port on the card (``torch.cuda.memory._record_memory_history`` and
    ``_snapshot``): the allocations live at the step's peak, each labelled
    by the line of ``repro_torch`` that made it, aggregated per (line,
    size) into :func:`top_buffers`' ``[(label, total_bytes)]`` and printed
    by :func:`format_buffers`.  On the card every kernel of the step runs,
    so the ranking is the kernel route's; the plain route is never ranked.

The text tools (:func:`grep_lines`, :func:`top_buffers`,
:func:`format_buffers`, :func:`peak_buffers`) are pure, and the unit tests
feed them text and snapshots directly.  :func:`sass_text` raises where the
library or ``cuobjdump`` is missing, :func:`step_snapshot` where there is
no CUDA device: neither falls back to anything.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

#: bytes per element for the HLO scalar types a buffer line can declare
DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2,
               "s64": 8, "u64": 8, "s32": 4, "u32": 4,
               "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1}

#: `%name = f32[8,128]{...} op(...)` — dtype, dims, op
_BUFFER_RE = re.compile(
    r"^\s*%?\S+ = (" + "|".join(DTYPE_BYTES) + r")\[([0-9,]+)\][^ ]* (\S+)")


def grep_lines(hlo_text: str, pattern: str, limit: int = 20) -> list[str]:
    """Lines of ``hlo_text`` matching ``pattern`` (regex), stripped and
    truncated to 240 chars, at most ``limit``."""
    pat = re.compile(pattern)
    out: list[str] = []
    for line in hlo_text.splitlines():
        if pat.search(line):
            out.append(line.strip()[:240])
            if len(out) >= limit:
                break
    return out


def top_buffers(hlo_text: str, min_bytes: float = 100e6,
                top: int = 25) -> list[tuple[str, int]]:
    """The largest buffer groups in ``hlo_text``: identical (op, dtype,
    shape) allocations above ``min_bytes`` are aggregated; returns
    ``[(label, total_bytes)]`` biggest first."""
    sizes: Counter = Counter()
    for line in hlo_text.splitlines():
        m = _BUFFER_RE.match(line)
        if not m:
            continue
        n = 1
        for d in m.group(2).split(","):
            n *= int(d)
        b = n * DTYPE_BYTES[m.group(1)]
        if b > min_bytes:
            sizes[f"{m.group(3)[:30]} {m.group(1)}[{m.group(2)}]"] += b
    return sizes.most_common(top)


def format_buffers(buffers: list[tuple[str, int]]) -> str:
    return "\n".join(f"{v / 1e9:8.2f} GB  {k}" for k, v in buffers)


# ------------------------------------------------------------ kernel text --
def library_path(kernel: str) -> Path:
    """The shared library ``kernels._build`` builds from
    ``csrc/<kernel>.cu`` for the current sources and flags."""
    from repro_torch.kernels import _build
    if kernel not in _build.SIGNATURES:
        raise ValueError(f"unknown kernel {kernel!r}; one of "
                         f"{sorted(_build.SIGNATURES)}")
    nvcc = _build._nvcc()
    return _build.BUILD_DIR / f"lib{kernel}-{_build._digest(nvcc)}.so"


def sass_text(kernel: str) -> str:
    """``cuobjdump -sass`` of the built library of ``kernel``.  Raises
    when the library is not built for the current sources or
    ``cuobjdump`` is missing."""
    from repro_torch.kernels import _build
    lib = library_path(kernel)
    if not lib.exists():
        raise FileNotFoundError(
            f"{lib} is not built: build the kernels first (python -c 'from "
            "repro_torch.kernels import _build; _build.build_all()')")
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    found = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return subprocess.run([found, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


# ---------------------------------------------------------------- buffers --
def _site(frames: list) -> str:
    """The innermost frame of ``repro_torch`` that made an allocation (its
    innermost frame if none is), as ``path:line function``."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            rel = name.split("repro_torch", 1)[1].lstrip("/\\")
            return f"{rel}:{f.get('line')} {f.get('name')}"
    if frames:
        return f"{frames[0].get('filename')}:{frames[0].get('line')}"
    return "<no Python frame>"     # e.g. the autograd engine's thread


def _replay(events: list, stop: int | None = None):
    """Live blocks ``{addr: (size, site)}`` after the first ``stop``
    events (all by default), the running total's peak and the count of
    events at which it was first reached.  A block counts from its
    ``alloc`` to its ``free_completed``."""
    live: dict[int, tuple[int, str]] = {}
    total = peak = peak_at = 0
    for i, ev in enumerate(events[:stop]):
        action, addr = ev.get("action"), ev.get("addr")
        if action == "alloc":
            live[addr] = (ev["size"], _site(ev.get("frames", [])))
            total += ev["size"]
            if total > peak:
                peak, peak_at = total, i + 1
        elif action == "free_completed" and addr in live:
            total -= live.pop(addr)[0]
    return live, peak, peak_at


def peak_buffers(snapshot: dict, min_bytes: float = 100e6,
                 top: int = 25) -> tuple[list[tuple[str, int]], int]:
    """The allocations live at the peak of a caching-allocator trace
    (``torch.cuda.memory._snapshot()``'s ``device_traces`` of one device,
    replayed from the first event): those above ``min_bytes`` aggregated
    per (site, size), ``[(label, total_bytes)]`` biggest first, and the
    peak's bytes."""
    events = [ev for trace in snapshot.get("device_traces", [])
              for ev in trace]
    _, peak, peak_at = _replay(events)
    live, _, _ = _replay(events, peak_at)
    sizes: Counter = Counter()
    for size, site in live.values():
        if size > min_bytes:
            sizes[f"{site} [{size} B]"] += size
    return sizes.most_common(top), peak


def step_snapshot(arch: str, shape: str, layers: int | None = None):
    """One step of the port on ``cuda:0`` at ``shape``'s sequence length
    and a batch of one, with ``arch`` cut to ``layers``: a train step
    (``make_train_step``, grad_accum 1; each checkpointed function
    recomputed whole), a prefill, or one decode token against a cache of
    the shape's length.  The allocator's history is
    recorded from before the weights are drawn.  Returns ``(snapshot,
    cfg, shape config, max_memory_allocated)``; raises where there is no
    CUDA device."""
    import torch
    from torch.utils import checkpoint

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as MD
    from repro_torch.optim import adamw
    if not torch.cuda.is_available():
        raise RuntimeError("hlo buffers records a step on the card; there "
                           "is no CUDA device")
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape!r}; one of {sorted(SHAPES)}")
    sc = SHAPES[shape]
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    cfg = cfg.replace(grad_accum=1)
    dev = torch.device("cuda", 0)
    torch.cuda.init()               # the allocator's stats need a context
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        params = MD.init_params(0, cfg, device=dev)
        if sc.kind == "train":
            opt = adamw.init(params, steps.moment_dtype_for(cfg))
            batch = MD.dummy_batch(cfg, 1, sc.seq_len, device=dev)
            # a checkpoint's recompute stops early by raising from a
            # saved-tensor hook, which the recorder's Python stack capture
            # turns into "error return without exception set": recompute
            # each checkpointed function whole instead
            with checkpoint.set_checkpoint_early_stop(False):
                steps.make_train_step(cfg)(params, opt, batch)
        elif sc.kind == "prefill":
            steps.make_prefill_step(cfg)(params, MD.dummy_batch(
                cfg, 1, sc.seq_len, kind="prefill", device=dev))
        else:
            cache = MD.init_cache(cfg, 1, sc.seq_len, device=dev)
            steps.make_decode_step(cfg)(params, cache, MD.dummy_batch(
                cfg, 1, 1, kind="decode", device=dev), sc.seq_len - 1)
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    return snap, cfg, sc, torch.cuda.max_memory_allocated(dev)


def main_grep(kernel: str, pattern: str, limit: int = 20) -> int:
    for line in grep_lines(sass_text(kernel), pattern, limit):
        print(line)
    return 0


def main_buffers(arch: str, shape: str, min_bytes: float = 100e6,
                 layers: int | None = None) -> int:
    from repro_torch.configs import get_config
    snap, cfg, sc, max_alloc = step_snapshot(arch, shape, layers)
    full = get_config(arch).n_layers
    print(f"{arch} {shape} ({sc.kind}): layers {cfg.n_layers} of {full}, "
          f"batch 1 of {sc.global_batch}, sequence {sc.seq_len}, on "
          "cuda:0 (the kernels' route)")
    bufs, peak = peak_buffers(snap, min_bytes)
    print(format_buffers(bufs))
    print("peak GB:", peak / 1e9, "max_memory_allocated GB:",
          max_alloc / 1e9)
    return 0


__all__ = ["DTYPE_BYTES", "format_buffers", "grep_lines", "library_path",
           "main_buffers", "main_grep", "peak_buffers", "sass_text",
           "step_snapshot", "top_buffers"]
