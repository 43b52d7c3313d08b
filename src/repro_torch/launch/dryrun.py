"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes in one process, and record memory, FLOP and collectives
per device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Outputs one JSON per cell under experiments/dryrun_torch/.

The JAX package lowers and compiles each cell for 512 forced host devices
and reads XLA's analyses.  Here one process stands for one rank of a fake
process group of 256 or 512 ranks (``torch.testing``'s ``fake`` backend:
collectives return at once) and runs one step of the port's sharded design
under ``FakeTensorMode`` (shapes only, no memory): the arguments are placed
by the rule tables (``parallel.sharding``) and the rank computes on its
shards.  In the train and prefill cells of the configs whose rule tables
shard over "model" (qwen2.5-32b, grok-1-314b, jamba-v0.1-52b) each layer
gathers its weights over the data axes only and the rank computes its own
heads, channels and experts (the tensor-parallel model of
``models.model``; its all-reduces and all-to-alls are recorded like any
collective).  Decode cells do the same for every config (the decode rule
table), over the rank's positions of the KV cache as ``cache_specs``
places it.  The ``fsdp_only`` configs' prefill cells run the rank on its
block of the sequence (``seq_over_model``).  Nothing is gathered whole but
the weights a rule table does not split.  The rank traced is rank 0, or
for a cell whose sequence is split the last rank of its sequence group
(:func:`traced_rank`, recorded): a split prefill's busiest, whose block
attends to every block before it.  Train cells run the sharded Trainer's
step (``make_train_step`` with the loss scaled by ``1 /
sharding.batch_ranks``, ``grad_accum`` microbatches placed one by one);
prefill and decode cells run the serve steps on the placed arguments.
A train step of more than ``MAX_TRACED_MICRO``
microbatches (grok-1's 16) is traced at 2 and 3 and extrapolated, each
microbatch past the first repeating the same work.  The Mamba and RWKV
training segments' backward recompute (the plain scan, a Python loop of
~40 ops a step) is traced as one op a segment and one for its VJP,
counted at the scan kernel's FLOP formula and twice that; their bytes
accessed are then only those ops' inputs and outputs.  Per traced rank
it records:
  - ``memory``: the argument bytes (the local shards) and, from
    ``MemTracker``, the peak of the step's own live tensors;
  - ``cost``: ``flops`` from ``FlopCounterMode`` (each model kernel is one
    ``torch.library`` op counted by the kernel's own FLOP formula), and
    ``bytes accessed``: every data-moving op's operand and result bytes,
    the traffic of eager PyTorch, which fuses nothing;
  - ``collectives``: operand bytes and counts by kind, recorded in
    ``CommDebugMode`` (:func:`collective_bytes`; the JAX package parses
    HLO text).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import register_flop_formula

from repro_torch import configs
from repro_torch._tree import leaves
from repro_torch.data import place_microbatches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import input_specs, make_train_step
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import P

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def _kind(name: str) -> str | None:
    n = name.replace("_", "")
    for key, kind in (("allgather", "all-gather"),
                      ("reducescatter", "reduce-scatter"),
                      ("allreduce", "all-reduce"), ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute")):
        if key in n:
            return kind
    return None


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _operand_bytes(func, args) -> int:
    """The bytes a collective sends: its input operand."""
    name = func._overloadpacket.__name__
    if name in ("_allgather_base_", "_reduce_scatter_base_"):
        return _nbytes(args[1])                 # (output, input, ...)
    first = args[0]
    if isinstance(first, (list, tuple)):
        return sum(_nbytes(t) for t in first)
    return _nbytes(first)


def collective_bytes(records) -> dict:
    """Sum the operand bytes of recorded collectives: ``records`` is a list
    of (kind, bytes), kinds as in the JAX package's HLO parser."""
    out = {k: 0 for k in KINDS}
    count = {k: 0 for k in KINDS}
    for kind, nbytes in records:
        out[kind] += nbytes
        count[kind] += 1
    out["counts"] = count
    out["total"] = sum(v for k, v in out.items() if k != "counts")
    return out


def _comm_recorder():
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops

    class CollectiveRecorder(CommDebugMode):
        """``CommDebugMode`` that also keeps each collective's kind and
        operand bytes (on the local tensors DTensor desugars to)."""

        def __init__(self):
            super().__init__()
            self.records: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            packet = getattr(func, "_overloadpacket", None)
            if packet is not None and not any(
                    t.__name__ == "DTensor" for t in types) and (
                    packet in self.comm_registry
                    or packet in c10d_collective_ops):
                kind = _kind(packet.__name__)
                if kind is not None:
                    self.records.append((kind, _operand_bytes(func, args)))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return CollectiveRecorder()


# ops that move no data (views, metadata, allocation)
_NO_DATA = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
            "expand", "slice", "select", "as_strided", "detach", "alias",
            "unsqueeze", "squeeze", "split", "split_with_sizes", "unbind",
            "chunk", "empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "lift_fresh", "_reshape_alias",
            "view_as_real", "view_as_complex", "unfold", "diagonal",
            "narrow", "movedim", "set_", "resize_", "record_stream",
            "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
            "is_same_size", "_local_scalar_dense", "wait_tensor"}


class BytesAccessed(TorchDispatchMode):
    """Sums every data-moving op's tensor operand and result bytes on the
    local tensors (DTensor ops are left to desugar first)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet is not None and packet.__name__ not in _NO_DATA:
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs,
                                                            out)))
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


# ------------------------------------------------ the scans' recompute ----
def _scan_ref(kind: str):
    from repro_torch.kernels.mamba_scan.ref import mamba_ssm_ref
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_wkv_ref
    return mamba_ssm_ref if kind == "mamba" else rwkv6_wkv_ref


def _scan_flop(kind: str, shapes) -> int:
    """The forward FLOP of a scan segment (the kernels' formulas)."""
    if kind == "mamba":
        B, S, di = shapes[0]
        return B * S * di * (7 * shapes[4][1] + 3)
    B, S, H, hd = shapes[0]
    return 7 * B * S * H * hd * hd


@torch.library.custom_op("repro_torch::dryrun_scan_segment", mutates_args=())
def _segment(inputs: list[torch.Tensor], kind: str, has_state: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    y, st = _scan_ref(kind)(*inputs, *([] if has_state else [None]))
    return y.clone(), st.clone()


@_segment.register_fake
def _(inputs, kind, has_state):
    x = inputs[0]
    if kind == "mamba":
        acc = torch.promote_types(x.dtype, torch.float32)
        return (x.new_empty(x.shape, dtype=acc),
                x.new_empty((x.shape[0], x.shape[2], inputs[4].shape[1]),
                            dtype=acc))
    B, _, H, hd = x.shape
    return x.new_empty(x.shape), x.new_empty((B, H, hd, hd))


@torch.library.custom_op("repro_torch::dryrun_scan_segment_vjp",
                         mutates_args=())
def _segment_vjp(inputs: list[torch.Tensor], kind: str, has_state: bool,
                 dy: torch.Tensor, d_state: torch.Tensor
                 ) -> list[torch.Tensor]:
    ref = _scan_ref(kind)
    _, vjp = torch.func.vjp(
        lambda *a: ref(*a, *([] if has_state else [None])), *inputs)
    return [g.clone() for g in vjp((dy, d_state))]


@_segment_vjp.register_fake
def _(inputs, kind, has_state, dy, d_state):
    return [torch.empty_like(t) for t in inputs]


@register_flop_formula(torch.ops.repro_torch.dryrun_scan_segment)
def _(shapes, kind, *args, **kwargs) -> int:
    return _scan_flop(kind, shapes)


@register_flop_formula(torch.ops.repro_torch.dryrun_scan_segment_vjp)
def _(shapes, kind, *args, **kwargs) -> int:
    return 2 * _scan_flop(kind, shapes)


def _segment_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[0])
    ctx.kind, ctx.has_state = inputs[1], inputs[2]


def _segment_backward(ctx, dy, d_state):
    saved = list(ctx.saved_tensors)
    if d_state is None:
        d_state = torch.zeros_like(_segment(saved, ctx.kind,
                                            ctx.has_state)[1])
    return _segment_vjp(saved, ctx.kind, ctx.has_state, dy, d_state), \
        None, None


_segment.register_autograd(_segment_backward, setup_context=_segment_setup)


def _traced_ref(kind: str):
    """The plain scan of a training segment's recompute as one op a
    segment (and its VJP as one more), for the trace: the backward's
    recompute is a Python loop over the segment's steps, ~40 ops a step,
    and traced op by op the train cells of jamba and rwkv6 would take
    hours.  FLOP: the scan kernel's formula, twice that for the VJP."""
    def ref(*args):
        *inputs, state = args
        if state is not None:
            inputs.append(state)
        return _segment(inputs, kind, state is not None)
    return ref


@contextlib.contextmanager
def _segment_ops():
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    old = mamba_ops.mamba_ssm_ref, wkv_ops.rwkv6_wkv_ref
    mamba_ops.mamba_ssm_ref = _traced_ref("mamba")
    wkv_ops.rwkv6_wkv_ref = _traced_ref("rwkv")
    try:
        yield
    finally:
        mamba_ops.mamba_ssm_ref, wkv_ops.rwkv6_wkv_ref = old


def _fake_group(n: int, rank: int = 0) -> None:
    """The default group as a fake group of ``n`` ranks, this process rank
    ``rank`` (an existing fake group of that size and rank is kept)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n \
                and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def make_mesh_by_name(mesh_name: str):
    """single | multi | "DxM" (custom data x model), over a fake group of
    its size."""
    if mesh_name in ("single", "multi"):
        shape = (2, 16, 16) if mesh_name == "multi" else (16, 16)
    else:
        shape = tuple(int(x) for x in mesh_name.split("x"))
    _fake_group(int(torch.tensor(shape).prod()))
    return make_mesh(shape)


def _local_bytes(tree) -> int:
    return sum(_nbytes(SH.local(x)) for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def _seq_axes(cell, mesh) -> tuple:
    """The mesh axes a serve cell's sequence is split over (none for a
    train cell): a prefill's batch over "model" for the fsdp_only configs
    (``batch_specs(seq_over_model=True)``), a decode's KV cache as
    ``cache_specs`` places it."""
    cfg = cell.cfg
    if cell.kind == "prefill" and cfg.fsdp_only:
        spec = SH.batch_specs(cell.args[1], mesh, seq_over_model=True)
        spec = next(iter(spec.values()))
    elif cell.kind == "decode":
        cache = cell.args[1]
        specs = SH.cache_specs(cfg, cache, mesh, cell.shape.global_batch)
        spec = next((s["k"] for s in specs if "k" in s), P())
    else:
        return ()
    ax = tuple(spec)[1] if len(tuple(spec)) > 1 else None
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def traced_rank(cell, mesh) -> int:
    """The rank a cell is traced as: rank 0, or for a cell whose sequence
    is split the last rank of its sequence group at coordinate 0 of every
    other axis (the busiest: a split prefill's last block attends to every
    block before it; a decode's last block holds the position it
    writes)."""
    axes = _seq_axes(cell, mesh)
    shape = SH.view(mesh).shape
    names = SH.view(mesh).axis_names
    coord = [shape[a] - 1 if a in axes else 0 for a in names]
    rank = 0
    for a, c in zip(names, coord):
        rank = rank * shape[a] + c
    return rank


def _placed(cell, mesh):
    """(args, step) of ``cell`` with the arguments placed on ``mesh``: the
    step takes them as placed (each rank computes on its own shards)."""
    cfg, kind = cell.cfg, cell.kind
    params = cell.args[0]
    pspec = SH.param_specs(params, mesh, mode=kind, fsdp_only=cfg.fsdp_only,
                           moe_ep=cfg.moe_ep)
    params = SH.distribute(params, pspec, mesh)
    if kind == "train":
        opt, batch = cell.args[1], cell.args[2]
        opt = AdamWState(m=SH.distribute(opt.m, pspec, mesh),
                         v=SH.distribute(opt.v, pspec, mesh), count=opt.count)
        micro = place_microbatches(batch, cfg.grad_accum, mesh,
                                   all_axes=cfg.fsdp_only)
        step = make_train_step(cfg, loss_scale=1.0 / SH.batch_ranks(
            mesh, all_axes=cfg.fsdp_only))
        return (params, opt, micro), step
    if kind == "prefill":
        batch = cell.args[1]
        bspec = SH.batch_specs(batch, mesh, seq_over_model=cfg.fsdp_only)
        return (params, SH.distribute(batch, bspec, mesh)), cell.step
    cache, batch, pos = cell.args[1:]
    cspec = SH.cache_specs(cfg, cache, mesh, cell.shape.global_batch)
    cache = SH.distribute(cache, cspec, mesh)
    batch = SH.distribute(batch, SH.batch_specs(batch, mesh), mesh)
    return (params, cache, batch, pos), cell.step


def _trace(step, args, mesh, dp_all: bool, decode: bool = False) -> dict:
    """One traced call of ``step`` under the cell's policy: FLOP, bytes
    accessed, data-moving ops, collectives and the peak of its own live
    tensors.  A decode step's argument shards are tracked from the start
    and their bytes taken off the peak: it writes its cache shards in
    place, and ``MemTracker`` counts an untracked storage that an op
    returns as new memory (the cache again, a layer at a time).  Train and
    prefill cells keep the count of earlier records, which takes the
    arguments that an op returns or updates in place as temporaries too
    (``PERF.md`` §7)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    mem, flops = MemTracker(), FlopCounterMode(display=False)
    comm, traffic = _comm_recorder(), BytesAccessed()
    held = 0
    if decode:
        shards = [SH.local(x) for x in leaves(args)
                  if isinstance(x, torch.Tensor)]
        mem.track_external(*shards)
        held = sum(_nbytes(x) for x in shards)
    with pctx.policy(mesh, dp_all_axes=dp_all), _segment_ops(), mem, \
            flops, comm, traffic:
        step(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(traffic.bytes), "ops": traffic.ops,
            "coll": collective_bytes(comm.records),
            "peak": max(snap["Total"] for snap in
                        mem.get_tracker_snapshot("peak").values()) - held}


def _extrapolated(t2: dict, t3: dict, n: int) -> dict:
    """A step of ``n`` microbatches from traces of 2 and 3: every
    microbatch past the first repeats the same work."""
    def lin(a, b):
        return a + (n - 2) * (b - a)
    coll = {k: lin(t2["coll"][k], t3["coll"][k]) for k in KINDS + ("total",)}
    coll["counts"] = {k: lin(t2["coll"]["counts"][k],
                             t3["coll"]["counts"][k]) for k in KINDS}
    return {"flops": lin(t2["flops"], t3["flops"]),
            "bytes": lin(t2["bytes"], t3["bytes"]),
            "ops": lin(t2["ops"], t3["ops"]), "coll": coll,
            "peak": max(t2["peak"], t3["peak"])}


#: a train cell of more microbatches than this is traced at 2 and 3 and
#: extrapolated (the trace costs ~0.2 ms a fake op)
MAX_TRACED_MICRO = 5


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: Path = OUT_DIR, verbose: bool = True) -> dict:
    mesh = make_mesh_by_name(mesh_name)
    n_chips = mesh.size()
    cell = input_specs(arch, shape_name)
    rank = traced_rank(cell, mesh)
    if rank:                                  # this process as that rank
        shape = tuple(SH.view(mesh).shape.values())
        _fake_group(int(n_chips), rank)
        mesh = make_mesh(shape)
    t0 = time.time()
    dp_all = cell.kind == "train" and cell.cfg.fsdp_only
    with cell.mode:
        args, step = _placed(cell, mesh)
        arg_bytes = _local_bytes(args)
        t_place = time.time() - t0
        micro = args[2] if cell.kind == "train" else None
        if micro is not None and len(micro) > MAX_TRACED_MICRO:
            t = _extrapolated(*(_trace(step, (*args[:2], micro[:k]), mesh,
                                       dp_all) for k in (2, 3)),
                              len(micro))
        else:
            t = _trace(step, args, mesh, dp_all, cell.kind == "decode")
        t_trace = time.time() - t0 - t_place
    coll, peak = t["coll"], t["peak"]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind, "n_chips": int(n_chips), "traced_rank": rank,
        "seq_len": cell.shape.seq_len,
        "global_batch": cell.shape.global_batch,
        "microbatches": None if micro is None else len(micro),
        "place_s": round(t_place, 2), "trace_s": round(t_trace, 2),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "temp_peak_in_bytes": int(peak),
                   "peak_in_bytes": arg_bytes + int(peak)},
        "cost": {"flops": t["flops"], "bytes accessed": t["bytes"]},
        "collectives": coll, "ops": t["ops"],
        "params_total": cell.cfg.param_counts()["total"],
        "params_active": cell.cfg.active_param_counts(),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    fn.write_text(json.dumps(rec, indent=1))
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"trace={t_trace:.1f}s args/dev={arg_bytes / 1e9:.2f}GB "
              f"peak/dev={(arg_bytes + peak) / 1e9:.2f}GB "
              f"flops/dev={rec['cost']['flops']:.3g} "
              f"coll/dev={coll['total'] / 1e9:.3f}GB", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out = Path(args.out)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for a, s, ok, why in configs.all_cells(include_skipped=True):
            if ok:
                cells.append((a, s))
            else:
                print(f"[dryrun] SKIP {a} x {s}: {why}")
    else:
        shapes = [args.shape] if args.shape else list(configs.SHAPES)
        archs = [args.arch] if args.arch else configs.ARCH_NAMES
        for a in archs:
            cfg = configs.get_config(a)
            for s in shapes:
                ok, why = configs.shape_applicable(cfg, configs.SHAPES[s])
                if ok:
                    cells.append((a, s))
                else:
                    print(f"[dryrun] SKIP {a} x {s}: {why}")

    failures = []
    for a, s in cells:
        for m in meshes:
            fn = out / f"{a}__{s}__{m}.json"
            if args.skip_existing and fn.exists():
                print(f"[dryrun] cached {fn.name}")
                continue
            try:
                run_cell(a, s, m, out)
            except Exception as e:  # noqa: BLE001
                failures.append((a, s, m, repr(e)))
                print(f"[dryrun] FAIL {a} x {s} x {m}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for f in failures:
            print("   ", f)
        return 1
    print(f"[dryrun] all {len(cells) * len(meshes)} cells traced OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
