"""Datapath linter: ast rules for the host-side anti-patterns of a PyTorch
datapath.  ``python -m repro_torch.analysis lint [paths...]``.

The JAX package's ``analysis/linter.py`` with its rules rewritten for
PyTorch's host syncs and transfers; the rule ids, the scoping and the
``# noqa: L-<ID>`` suppression are the same.  Rules (:data:`RULES`;
subjects are ``path:line``):

  - **L-HOSTSYNC** (error): a host synchronization inside a loop —
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize()`` or an event's / a stream's
    ``.synchronize()``, ``np.asarray`` / ``np.array`` over tensors, or
    ``int()`` / ``float()`` over a subscripted tensor — each iteration
    waits for the device, serializing the loop (one sync per run, not per
    item).  Ring-aware: a ``.synchronize()`` whose operands name a
    dispatch-ring entry (``ring``/``slot``/``inflight``) is the streaming
    engine's *bounded* per-slot drain — one wait per ring wrap by design,
    ``max_inflight`` launches deep (``api/compute_backend.py``
    ``DispatchRing``) — and is not flagged.
  - **L-RING** (warning): a host-to-device copy inside a loop in a
    dispatch-path file with no dispatch-ring slot in sight —
    ``.to(<device>)``, ``.cuda()``, ``torch.as_tensor(..., device=...)``
    or ``torch.tensor(..., device=...)`` ships a fresh host buffer to the
    device every iteration instead of cycling a pre-allocated ring slot.
    Exempt when the call's operands name a ring slot.
  - **L-JITCACHE** (error): ``torch.compile(...)``,
    ``torch.cuda.CUDAGraph()`` or a kernel build (``_build.build_all()``,
    ``_build.library(...)``) inside a loop — each iteration makes a fresh
    compiled program, graph or build lookup instead of reusing one.
  - **L-NONDET** (warning): nondeterminism hazards inside the
    determinism-critical trees — the event-sim core
    (``src/repro_torch/core/``) and the workload plane
    (``src/repro_torch/workloads/``) — wall-clock reads, unseeded global
    randomness, ``torch.rand`` / ``randn`` / ``randint`` / ``randperm``
    without ``generator=``, and ``torch.manual_seed`` (which reseeds the
    process-wide generator under every other caller).
  - **L-SYNTAX** (error): the file does not parse.
  - **L-DONATE**: no counterpart.  PyTorch frees a dead input when its
    last reference goes, and ``ComputeBackend`` has no ``donate`` (a
    deliberate difference of the port), so nothing is emitted.

Detection is lexical ast walking, scoped tight enough to run clean on a
well-behaved tree: loop-sensitive rules only fire under a ``for`` /
``while`` / comprehension; ``np.asarray`` / ``np.array`` and ``int()`` /
``float()`` over a *subscript* only in files importing torch; L-RING only
in files whose path matches a dispatch component (``backend``,
``engine``, ``kernels``, ``serving``).
"""
from __future__ import annotations

import ast
import os

from .diagnostics import Diagnostic, Severity

#: rule id -> (severity, what it flags); L-DONATE has no counterpart
RULES = {
    "L-HOSTSYNC": (Severity.ERROR, "a host sync inside a loop"),
    "L-RING": (Severity.WARNING, "a host-to-device copy inside a dispatch "
               "loop with no ring slot"),
    "L-JITCACHE": (Severity.ERROR, "a compile, graph or kernel build "
                   "inside a loop"),
    "L-NONDET": (Severity.WARNING, "wall-clock or unseeded randomness in "
                 "the sim core or the workload plane"),
    "L-SYNTAX": (Severity.ERROR, "the file does not parse"),
    "L-DONATE": (None, "no counterpart: PyTorch frees dead inputs by "
                 "refcount, and ComputeBackend has no donate"),
}

#: attribute calls that wait for the device and copy to the host
_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize")
#: module calls that materialize a tensor on the host
_SYNC_CALLS = {("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
               ("numpy", "array")}
#: wall-clock / unseeded-randomness calls banned in the event-sim core
_NONDET_CALLS = {("time", "time"), ("time", "perf_counter"),
                 ("time", "monotonic"), ("datetime", "now"),
                 ("random", "random"), ("random", "randint"),
                 ("random", "uniform"), ("random", "choice"),
                 ("random", "shuffle"), ("random", "sample")}
#: torch's global-generator draws, flagged without ``generator=``
_TORCH_RANDOM = ("rand", "randn", "randint", "randperm")
#: path fragments that mark a file as dispatch-path for L-RING
_DISPATCH_HINTS = ("backend", "engine", "kernels", "serving")
#: identifier fragments that mark a value as a dispatch-ring entry
_RING_HINTS = ("ring", "slot", "inflight", "in_flight")
#: the kernel build calls of ``repro_torch.kernels._build``
_BUILD_CALLS = ("build_all", "library")


def _touches_ring(node: ast.AST) -> bool:
    """True when any identifier in the subtree names a dispatch-ring entry
    (``ring``/``slot``/``inflight``) — the lexical signal that a sync or
    transfer is ring-scoped, i.e. bounded by the in-flight window rather
    than per-item."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.keyword):
            name = sub.arg
        if name and any(h in name.lower() for h in _RING_HINTS):
            return True
    return False


def _is_sync_subscript(node: ast.Subscript) -> bool:
    """True when ``int(x[...])`` plausibly reads a tensor element: the
    subscripted value is a plain name/attribute chain that is not a
    ``.shape``-style metadata read.  Subscripts of call results
    (``x.split("_")[1]``) are host values, not tensor indexing."""
    if isinstance(node.value, ast.Attribute) \
            and node.value.attr in ("shape", "dims", "strides"):
        return False
    return isinstance(node.value, (ast.Name, ast.Attribute))


def _imports_torch(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module and (node.module == "torch"
                                or node.module.startswith("torch.")):
                return True
    return False


def _dotted(node) -> tuple[str, ...] | None:
    """x.y.z -> ("x", "y", "z") for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _names_device(node: ast.AST) -> bool:
    """True when ``node`` lexically names a device: a name or attribute
    ending in ``device``/``dev``, a ``"cuda..."``/``"cpu"`` literal, or a
    ``torch.device(...)`` call (``.to(torch.float32)`` is a cast, not a
    copy)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith(("cuda", "cpu"))
    if isinstance(node, ast.Call):
        return _dotted(node.func) == ("torch", "device")
    dotted = _dotted(node)
    return bool(dotted) and dotted[-1].lower().endswith(("device", "dev"))


def _is_transfer(node: ast.Call, dotted) -> bool:
    """``.to(<device>)``, ``.cuda()``, or ``torch.as_tensor`` /
    ``torch.tensor`` with ``device=``."""
    kw = {k.arg for k in node.keywords}
    if dotted in (("torch", "as_tensor"), ("torch", "tensor")):
        return "device" in kw
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "cuda":
        return True
    return node.func.attr == "to" and (
        "device" in kw or bool(node.args) and _names_device(node.args[0]))


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, in_core: bool, is_torch_file: bool):
        self.relpath = relpath
        self.in_core = in_core
        self.is_torch_file = is_torch_file
        self.loop_depth = 0
        self.diags: list[Diagnostic] = []

    # ------------------------------------------------------------- helpers --
    def _emit(self, rule: str, node: ast.AST, message: str,
              hint: str) -> None:
        self.diags.append(Diagnostic(
            rule, RULES[rule][0], f"{self.relpath}:{node.lineno}", message,
            hint))

    def _in_loop(self) -> bool:
        return self.loop_depth > 0

    # --------------------------------------------------------------- loops --
    def _loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = visit_While = visit_AsyncFor = _loop
    visit_ListComp = visit_SetComp = visit_DictComp = _loop
    visit_GeneratorExp = _loop

    # --------------------------------------------------------------- calls --
    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)

        if self._in_loop():
            self._loop_call(node, dotted)

        if self.in_core and dotted:
            if (dotted[0], dotted[-1]) in _NONDET_CALLS:
                self._nondet(node, f"{'.'.join(dotted)}()",
                             "wall-clock or unseeded randomness")
            elif dotted[0] == "torch" and (
                    dotted[1:] == ("manual_seed",)
                    or len(dotted) == 2 and dotted[1] in _TORCH_RANDOM
                    and not any(k.arg == "generator"
                                for k in node.keywords)):
                self._nondet(node, f"{'.'.join(dotted)}()",
                             "torch's process-wide generator")

        self.generic_visit(node)

    def _loop_call(self, node: ast.Call, dotted) -> None:
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if attr in _SYNC_ATTRS and not (attr == "synchronize"
                                        and _touches_ring(node)):
            self._emit(
                "L-HOSTSYNC", node,
                f".{attr}() inside a loop waits for the device every "
                "iteration",
                "hoist the sync out of the loop: batch the values and "
                "synchronize once after it; a dispatch-ring drain should "
                "name its ring slot")
        elif dotted and (dotted[0], dotted[-1]) in _SYNC_CALLS \
                and self.is_torch_file:
            self._emit(
                "L-HOSTSYNC", node,
                f"{'.'.join(dotted)}() inside a loop pulls a tensor to "
                "the host every iteration",
                "stack the per-iteration tensors on the device and "
                "convert once after the loop")
        elif dotted in (("int",), ("float",)) and node.args \
                and isinstance(node.args[0], ast.Subscript) \
                and _is_sync_subscript(node.args[0]) \
                and self.is_torch_file:
            self._emit(
                "L-HOSTSYNC", node,
                f"{dotted[0]}(x[...]) inside a loop forces the tensor "
                "element to the host every iteration",
                "keep per-iteration results on the device; copy the "
                "stacked batch once after the loop")
        if dotted in (("torch", "compile"), ("torch", "cuda", "CUDAGraph")) \
                or dotted and len(dotted) >= 2 and dotted[-2] == "_build" \
                and dotted[-1] in _BUILD_CALLS:
            self._emit(
                "L-JITCACHE", node,
                f"{'.'.join(dotted)}(...) inside a loop makes a fresh "
                "compiled program, graph or build lookup every iteration",
                "compile, capture or build once outside the loop, or "
                "memoize per static shape")
        if _is_transfer(node, dotted) \
                and any(h in self.relpath for h in _DISPATCH_HINTS) \
                and not _touches_ring(node):
            self._emit(
                "L-RING", node,
                "a host-to-device copy inside a loop on the dispatch path "
                "allocates and ships a fresh buffer every iteration",
                "stage through a pre-allocated dispatch-ring slot (name it "
                "ring/slot/inflight) so the steady state reuses buffers, "
                "or hoist the transfer")

    def _nondet(self, node: ast.Call, what: str, why: str) -> None:
        self._emit(
            "L-NONDET", node,
            f"{what} in a determinism-critical tree (event-sim core / "
            f"workload plane): {why} makes simulation and trace replay "
            "unreproducible",
            "thread a seeded random.Random(seed) / torch.Generator / "
            "injected clock through instead")


def lint_source(source: str, relpath: str) -> list[Diagnostic]:
    """Lint one file's source text; returns its diagnostics after noqa
    filtering."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Diagnostic(
            "L-SYNTAX", Severity.ERROR, f"{relpath}:{e.lineno or 0}",
            f"file does not parse: {e.msg}", hint="fix the syntax error")]
    norm = relpath.replace(os.sep, "/")
    v = _Visitor(norm,
                 in_core="repro_torch/core/" in norm
                 or "repro_torch/workloads/" in norm,
                 is_torch_file=_imports_torch(tree))
    v.visit(tree)
    lines = source.splitlines()
    out = []
    for d in v.diags:
        lineno = int(d.subject.rsplit(":", 1)[1])
        line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        if "# noqa" in line and d.rule in line.split("# noqa", 1)[1]:
            continue
        out.append(d)
    return out


def lint_paths(paths: list[str], root: str = ".") -> list[Diagnostic]:
    """Lint every ``.py`` file under the given files/directories; subjects
    are ``root``-relative paths."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _dirs, names in os.walk(p):
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(names) if n.endswith(".py"))
        else:
            files.append(p)
    diags: list[Diagnostic] = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        diags.extend(lint_source(src, os.path.relpath(f, root)))
    return diags


__all__ = ["RULES", "lint_paths", "lint_source"]
