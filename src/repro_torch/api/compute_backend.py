"""ComputeBackend: NT names bound to batched PyTorch code and, for the VPC
chain, to one hand-written CUDA kernel — the batch runtime.

The counterpart of the JAX package's ``api/compute_backend.py``.  The same
builder DAG that drives the event simulator executes here as real compute.
Each compute NT is a function over a *packet-batch state* (a dict of
tensors: ``headers`` (N, 5) u32, ``payload`` (N, 16) u32, ``allow`` (N,)
bool, ``ctr`` (N,) u32, ...); chaining composes the functions.

Runtime design (the paper's "schedule the chain once" insight, §4.2, applied
to the host runtime):

  - **Fused-kernel fast path.**  A linear chain whose stage names match a
    registered fused kernel (``firewall >> nat >> chacha20`` ->
    :func:`repro_torch.kernels.vpc_datapath.vpc_datapath`) dispatches to it:
    one CUDA launch for the whole chain, packet state in registers across
    all NTs.  Everything else runs the composed PyTorch path.  The fused
    path is the default where the backend's device is CUDA.
  - **Shape buckets and a program cache.**  Batches are padded to
    power-of-two buckets; the program cache is keyed by (bucket, path) and
    ``stats["traces"]`` counts its misses, so it equals the number of
    distinct buckets a deployment has seen.  Pad rows are safe for the
    built-in NTs because every one is row-wise (pad outputs are sliced off
    after the run); a custom ``ComputeNT`` that reduces *across* packets
    must mask with the ``state["valid"]`` row mask the runtime provides.
  - **Scheduler-ordered batch composition.**  Pending injects live in
    per-tenant :class:`repro_torch.core.sched.FairScheduler` queues;
    ``run()`` drains them in weighted deficit-round-robin order (cost = wire
    bytes), so a heavy tenant's backlog cannot starve a light tenant within
    a run.  Injects for unregistered tenants are an error.
  - **Batch coalescing.**  *Consecutive* same-DAG, same-signature entries of
    the fair drain order merge into one dispatch.  The ChaCha keystream
    counter is per-packet *state* (``ctr``, synthesized at inject time), so
    merging or reordering batches never changes any packet's ciphertext.
  - **One device sync per run().**  Every pending batch is launched
    asynchronously on the current CUDA stream; one
    ``torch.cuda.synchronize`` at the end is the only host<->device
    synchronization point, and the throughput window.
  - **Fresh buffers.**  Bucket filling always allocates a new device buffer
    (where the JAX package donated buffers to XLA), so a caller's tensors
    are never aliased: inject the same tensors twice and both runs see
    identical bits.
  - **Streaming engine** (``run(stream=True)`` / :meth:`inject_stream` /
    ``ComputeBackend(stream=True)``): the pipelined alternative to the
    batch-synchronous drain.  Batches flow through a **dispatch ring** of
    pre-allocated, reusable staging slots per (bucket, signature): on a
    CUDA device a slot is a set of pinned host tensors, so steady state
    fills ring slots instead of materializing fresh buffers, and each
    slot's ``non_blocking`` host->device copy runs on a copy stream of its
    own, overlapping the previous group's still-running kernel; the
    compute stream waits on an event recorded after the copy.  The single
    end-of-run sync becomes a bounded in-flight window (``max_inflight``):
    a group's completion event is waited on only when the ring wraps, and
    only then is its slot handed out again.  With a device *list*,
    dispatch groups round-robin across the devices of one shard;
    stream-mode ChaCha stays bit-exact because per-packet counters are
    assigned when an item enters the ring (fair drain order,
    deterministic), never at completion time.  The throughput window for
    a streaming run is first-dispatch -> last-drain.  ``inject_stream``
    services a continuous inject source epoch-by-epoch through the
    scheduler's stream-credit window
    (:meth:`repro_torch.core.sched.FairScheduler.stream_window`) instead
    of draining a static backlog.

Fork/join semantics mirror the sync buffer (§4.2): every branch of a stage
reads the stage's input state; the join merges each branch's declared
``writes``.  Two branches writing the same field is a build-time error.

Egress applies the firewall verdict the way the fixed sNIC datapath does:
denied packets keep their original header and leave with a zeroed payload
(bit-exact with ``vpc_chain``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch import _device
from repro_torch._u32 import MASK, arange32, narrow, where32
from repro_torch.analysis import invariants as _sanitize
from repro_torch.core.nt import GBPS, NTDag, NTSpec
from repro_torch.core.sched import FairScheduler, SchedConfig
from repro_torch.kernels.chacha20.ops import smem_tile_bytes as _chacha_tile
from repro_torch.kernels.vpc_datapath.ops import (datapath_args,
                                                  vpc_datapath_prepared)
from repro_torch.kernels.vpc_datapath.ops import smem_tile_bytes as _vpc_tile
from repro_torch.serving.vpc import chacha20_xor, firewall, nat_rewrite

from .backend import PlatformReport, TenantReport
from .dag import DagError

#: fields that actually cross the wire; everything else (verdict bits,
#: counters, validity masks, scratch) is metadata and must not count
#: toward Gbps
WIRE_FIELDS = ("headers", "payload")

#: smallest pad bucket; buckets are _MIN_BUCKET * 2**k
_MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Smallest power-of-two bucket (>= _MIN_BUCKET) holding ``n`` rows.

    Exact fits stay in their bucket (``bucket_size(2**k) == 2**k``)."""
    if n < 0:
        raise ValueError(f"bucket_size needs n >= 0, got {n}")
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


@dataclass(frozen=True)
class ComputeNT:
    """One network task as real compute.

    ``fn(state, params) -> updates``: reads any state fields, returns the
    dict of fields it produces.  ``writes`` declares those fields so the
    fork/join merge can detect conflicts at build time.  ``prep(n, params)``
    optionally synthesizes per-packet state fields at inject time (e.g. the
    ChaCha keystream counter) so that batch coalescing and bucket padding
    cannot change the NT's output for any real packet; it runs with the
    device of the batch's packets as PyTorch's default device.
    ``prep_fields`` names them, so inject can skip ``prep`` when the caller
    already supplied every one.

    The remaining fields are admission-verifier metadata
    (:mod:`repro_torch.analysis.verifier`), all optional: ``reads`` declares
    the state fields ``fn`` consumes so dataflow holes surface at deploy
    time; ``schema`` pins per-field trailing shape and dtype as
    ``((field, trailing_shape, dtype), ...)`` tuples; ``tile_bytes`` is the
    NT kernel's per-block shared-memory footprint, summed per fused branch
    against the per-block budget.
    """
    name: str
    fn: Callable[[dict, dict], dict]
    writes: tuple[str, ...]
    prep: Callable[[int, dict], dict] | None = None
    prep_fields: tuple[str, ...] = ()
    reads: tuple[str, ...] = ()
    schema: tuple[tuple[str, tuple[int, ...], str], ...] = ()
    tile_bytes: int = 0
    #: optional stream-state synthesizer, ``stream(n, params, state) ->
    #: (fields, new_state)``.  Activated per deployment with
    #: ``params[name]["stream"] = True``: instead of ``prep`` at inject
    #: time, the per-packet fields are assigned at *dispatch* time from a
    #: running per-deployment state (e.g. a continuing ChaCha ``ctr``
    #: across batches), which export/import_state carry across a failover.
    stream: Callable[[int, dict, dict], tuple[dict, dict]] | None = None


# ------------------------------------------------------- built-in NT library --
def _fw_nt(state, params):
    allow = firewall(state["headers"], params["rules"])
    prev = state.get("allow")
    return {"allow": allow if prev is None else prev & allow}


def _nat_nt(state, params):
    return {"headers": nat_rewrite(state["headers"],
                                   params.get("nat_ip", 0x0A000001))}


def _chacha_nt(state, params):
    ctr = state.get("ctr")
    if ctr is None and "ctr0" in state:
        # per-dispatch counter base: a 0-d tensor expanded on the device
        # (pad rows get counters past the batch; their output is sliced off
        # like any pad row)
        ctr = arange32(state["ctr0"], state["payload"].shape[0])
    return {"payload": chacha20_xor(state["payload"], params["key"],
                                    params["nonce"],
                                    params.get("counter0", 1), ctr=ctr)}


def _chacha_prep(n, params):
    return {"ctr": narrow(arange32(params.get("counter0", 1), n))}


def _chacha_stream(n, params, state):
    """Stream-mode ``ctr``: a running keystream counter that continues
    across batches (and, via export/import_state, across a crash/recover
    cycle).  With ``params["scalar_ctr"]`` the per-packet array is replaced
    by a scalar ``ctr0`` base expanded on the device; a 0-d field is its
    own dispatch signature, so such batches never coalesce and each keeps
    exactly its own counter run."""
    nxt = int(state.get("next_ctr", params.get("counter0", 1)))
    if params.get("scalar_ctr"):
        return ({"ctr0": narrow(torch.tensor(nxt & MASK))},
                {"next_ctr": nxt + n})
    return ({"ctr": narrow(arange32(nxt, n))}, {"next_ctr": nxt + n})


BUILTIN_COMPUTE_NTS: dict[str, ComputeNT] = {
    "firewall": ComputeNT(
        "firewall", _fw_nt, writes=("allow",), reads=("headers",),
        schema=(("headers", (5,), "uint32"), ("allow", (), "bool")),
        # fused-kernel share: the staged rule chunk and the tile's header
        # rows, counters and allowed list
        tile_bytes=_vpc_tile() - _chacha_tile()),
    "nat": ComputeNT(
        "nat", _nat_nt, writes=("headers",), reads=("headers",),
        schema=(("headers", (5,), "uint32"),),
        tile_bytes=0),       # rewrites the header rows the firewall staged
    "chacha20": ComputeNT(
        "chacha20", _chacha_nt, writes=("payload",),
        reads=("payload", "ctr"),
        schema=(("payload", (16,), "uint32"), ("ctr", (), "uint32")),
        prep=_chacha_prep, prep_fields=("ctr",), stream=_chacha_stream,
        tile_bytes=_chacha_tile()),
}

# nominal service models for the same NT names on the sim substrate, so one
# spec registry can front both backends
VPC_SPECS: dict[str, NTSpec] = {
    "firewall": NTSpec("firewall", max_gbps=100.0, fixed_ns=300.0),
    "nat": NTSpec("nat", max_gbps=100.0, fixed_ns=300.0),
    "chacha20": NTSpec("chacha20", max_gbps=80.0, fixed_ns=500.0),
}


# --------------------------------------------------- fused kernel registry --
def _vpc_fused_factory(params: dict) -> Callable | None:
    """Fused launcher for the canonical VPC chain, or None if the deployment
    params cannot feed the fused kernel (missing rules/key/nonce).  The
    deploy-time params are only a capability probe: every param is read
    from the runtime params argument, the same binding the composed path
    gives every NT.  The kernel's fixed inputs (rule table, key, nonce, NAT
    address) built from them are kept per device in ``program.prepared``
    together with the param objects they came from, and rebuilt when any of
    those objects is replaced, so a dispatch whose params are unchanged
    launches the kernel and nothing else."""
    try:
        params["firewall"]["rules"]
        params["chacha20"]["key"]
        params["chacha20"]["nonce"]
    except (KeyError, TypeError):
        return None

    def program(state: dict, params: dict) -> dict:
        ch = params["chacha20"]
        # held by reference and compared with ``is``: a recycled id()
        # cannot alias a replaced param
        sources = (params["firewall"]["rules"], ch["key"], ch["nonce"],
                   params.get("nat", {}).get("nat_ip", 0x0A000001))
        dev = state["headers"].device
        entry = program.prepared.get(dev)
        if entry is None or any(a is not b
                                for a, b in zip(entry[0], sources)):
            entry = (sources, datapath_args(*sources, dev))
            program.prepared[dev] = entry
        allow, hout, pout = vpc_datapath_prepared(
            state["headers"], state["payload"], entry[1],
            # ctr0 is a stream-mode counter base (a 0-d tensor on the
            # device; the wrapper expands it there)
            counter0=state.get("ctr0", ch.get("counter0", 1)),
            ctr=state.get("ctr"))
        return {**state, "allow": allow, "headers": hout, "payload": pout}

    #: device -> (the param objects read, the kernel's fixed inputs built
    #: from them on that device)
    program.prepared = {}
    return program


#: exact linear-chain stage names -> fused program factory(params)
FUSED_KERNELS: dict[tuple[str, ...], Callable[[dict], Callable | None]] = {
    ("firewall", "nat", "chacha20"): _vpc_fused_factory,
}


def _linear_chain(dag: NTDag) -> tuple[str, ...] | None:
    """The dag's NT names if it is one linear chain, else None."""
    names: list[str] = []
    for stage in dag.stages:
        if len(stage) != 1:
            return None
        names.extend(stage[0])
    return tuple(names)


# ----------------------------------------------------------- runtime state --
@dataclass
class _Deployment:
    dag: NTDag
    params: dict
    fused: Callable | None                    # fused program or None
    composed: Callable                        # composed program (fallback)
    results: list = field(default_factory=list)
    # (bucket_rows, path) -> program; the cache is explicit and countable
    cache: dict[tuple[int, str], Callable] = field(default_factory=dict)
    #: per-NT running stream state (plain scalars, checkpointable); only
    #: advanced at dispatch time, so it always reflects completed work
    nt_state: dict[str, dict] = field(default_factory=dict)


def _is_array(v) -> bool:
    return hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1


def _as_tensor(v):
    """numpy arrays become tensors (on the CPU); tensors pass through."""
    return torch.from_numpy(np.ascontiguousarray(v)) \
        if isinstance(v, np.ndarray) else v


def _nbytes(v) -> int:
    return v.numel() * v.element_size()


def _rows(batch: dict) -> int:
    for v in batch.values():
        if _is_array(v):
            return int(v.shape[0])
    return 0


def _signature(batch: dict):
    """Coalescing key: batches merge only when their field names, trailing
    shapes and dtypes agree (tensors concatenate along the packet axis)."""
    items = []
    for k in sorted(batch):
        v = batch[k]
        if _is_array(v):
            items.append((k, tuple(v.shape[1:]), str(v.dtype)))
        else:                      # non-array field: never coalesced
            items.append((k, "scalar", id(v)))
    return tuple(items)


def _batch_device(batch: dict, default: torch.device) -> torch.device:
    """Where a batch's packets live (its first tensor's device): the
    per-packet state synthesized for it (the ChaCha ``ctr``) is made there
    too, so host-resident packets get host-resident counters."""
    for v in batch.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return default


# ------------------------------------------------------------ dispatch ring --
def _host_buffer(shape: tuple, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A zeroed host tensor; ``pin`` asks for page-locked memory, which a
    ``non_blocking`` copy to a CUDA device needs to run asynchronously.
    Pageable memory in its place would make every copy synchronous, so a
    buffer that could not be pinned is an error, not a quiet fallback."""
    buf = torch.zeros(shape, dtype=dtype, pin_memory=pin)
    if pin and not buf.is_pinned():
        raise RuntimeError("the dispatch ring could not pin a staging buffer")
    return buf


@dataclass
class _RingSlot:
    """One pre-allocated staging slot: host tensors sized to a bucket, one
    per tensor field of the dispatch signature (plus the ``valid`` row
    mask), pinned when the slot feeds a CUDA device.  The slot is filled in
    place, copied to the device, and returned to the ring's free list only
    when its in-flight entry retires, after the event that follows its
    copy and its program: steady state allocates nothing, and a slot is
    never refilled while a copy may still read it."""
    key: tuple
    staging: dict[str, torch.Tensor]


class DispatchRing:
    """Pool of reusable staging slots keyed by (bucket, tensor signature,
    pinned or not).

    ``allocs`` counts real slot materializations; once the pipeline warms
    up (at most ``max_inflight + 1`` slots per key are ever live) every
    acquire is a reuse, the zero-steady-state-allocation property the
    streaming tests assert.  A field's trailing shape ``None`` marks a 0-d
    field (a stream-mode counter base), staged as one 0-d tensor."""

    def __init__(self, depth: int = 4):
        self.depth = int(depth)
        self._free: dict[tuple, list[_RingSlot]] = {}
        self.allocs = 0
        self.reuses = 0

    def acquire(self, bucket: int,
                fields: list[tuple[str, tuple[int, ...] | None,
                                   torch.dtype]],
                pin: bool = False) -> _RingSlot:
        key = (bucket, tuple((k, trail, str(dt)) for k, trail, dt in fields),
               pin)
        free = self._free.get(key)
        if free:
            self.reuses += 1
            return free.pop()
        self.allocs += 1
        staging = {k: _host_buffer(() if trail is None else (bucket,) + trail,
                                   dt, pin)
                   for k, trail, dt in fields}
        staging["valid"] = _host_buffer((bucket,), torch.bool, pin)
        return _RingSlot(key, staging)

    def release(self, slot: _RingSlot) -> None:
        self._free.setdefault(slot.key, []).append(slot)

    def stats(self) -> dict:
        return {"allocs": self.allocs, "reuses": self.reuses,
                "depth": self.depth,
                "free_slots": sum(len(v) for v in self._free.values())}


@dataclass
class _InFlight:
    """A launched-but-undrained dispatch group: the ring entry the bounded
    in-flight window retires when the ring wraps.  ``done`` is the CUDA
    event recorded after its program (None on the CPU, where the program
    has finished when it returns)."""
    dep: _Deployment
    orders: list[int]
    sizes: list[int]
    out: dict
    slot: _RingSlot | None
    enq: list[tuple[str, float]]          # (tenant, enqueued_at) per batch
    done: torch.cuda.Event | None = None


def _fill_bucket(arrays, b: int, device) -> torch.Tensor:
    """One fresh bucket buffer on ``device`` filled at per-batch offsets:
    coalescing and pad-to-bucket in a single copy of the packet data, never
    aliasing a caller's tensor."""
    first = arrays[0]
    buf = torch.empty((b,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=device)
    off = 0
    for a in arrays:
        buf[off:off + a.shape[0]] = a
        off += a.shape[0]
    buf[off:] = 0                              # pad rows
    return buf


def _corrupt_batch(batch: dict, rng) -> dict:
    """Injected data fault: flip one payload bit (deterministic under the
    FaultState's seeded rng)."""
    pl = batch.get("payload")
    if not isinstance(pl, torch.Tensor) or pl.numel() == 0:
        return batch
    if pl.dtype.is_floating_point or pl.dtype.is_complex \
            or pl.dtype == torch.bool:
        return batch
    flat = pl.reshape(-1).to(torch.int64)      # u32 has no xor on CUDA
    i = rng.randrange(flat.numel())
    bit = rng.randrange(8 * pl.element_size())
    flat[i] ^= (1 << bit) - (1 << 64 if bit == 63 else 0)
    out = dict(batch)
    out["payload"] = flat.to(pl.dtype).reshape(pl.shape)
    return out


def _slice_result(out: dict, off: int, s: int) -> dict:
    """Un-coalesce one batch's rows out of a dispatched group's output,
    dropping the pad/validity scaffolding."""
    res = {}
    for k, v in out.items():
        if k == "valid":
            continue
        res[k] = v[off:off + s] if _is_array(v) else v
    return res


def _pad_to(x, b: int, device) -> torch.Tensor:
    """Pad the packet axis to ``b`` rows on ``device``.  Always materializes
    a fresh buffer (even when no padding is needed, and for 0-d tensors) so
    a program never writes into a caller-owned tensor."""
    x = _as_tensor(x)
    if x.ndim == 0:
        return x.to(device).clone()
    return _fill_bucket([x], b, device)


def _select(allow, new, old):
    """Egress ``where`` over one field (u32 goes through int64: PyTorch has
    no u32 ``where`` on CUDA); ``old`` may be 0."""
    if new.dtype == torch.uint32:
        return where32(allow[:, None], new, old)
    if not isinstance(old, torch.Tensor):
        old = torch.zeros_like(new)
    return torch.where(allow[:, None], new, old)


class ComputeBackend:
    name = "compute"

    def __init__(self, nts: dict[str, ComputeNT] | None = None,
                 use_fused: bool | None = None,
                 quantum_bytes: float = 8 * 1500.0,
                 name: str | None = None, device=None,
                 capacity_gbps: float = 100.0, stream: bool = False,
                 ring_depth: int = 4, max_inflight: int | None = None):
        """``device``: where batches run — ``None`` is ``cuda:0`` (and raises
        where no GPU is present: pass ``device="cpu"`` for the plain
        PyTorch path on the CPU), an int is a CUDA ordinal, or a string /
        ``torch.device``.  A *list* of devices round-robins this shard's
        dispatch groups across them.  ``capacity_gbps`` is the nominal
        wire capacity a placer provisions against.  ``use_fused`` defaults
        to True on a CUDA device.

        ``stream=True`` makes ``run()`` default to the pipelined streaming
        engine; ``ring_depth`` sizes the dispatch ring's staging pool and
        ``max_inflight`` (default: ``ring_depth``) bounds how many launched
        dispatch groups may be awaiting their drain at once."""
        if name is not None:
            self.name = name
        devs = list(device) if isinstance(device, (list, tuple)) \
            else [device]
        self.devices = [_device.resolve(d) for d in devs]
        self.device = self.devices[0]
        self._rr = 0                       # round-robin device cursor
        self.capacity_gbps = capacity_gbps
        self.stream = stream
        self.ring_depth = max(1, int(ring_depth))
        self.max_inflight = self.ring_depth if max_inflight is None \
            else max(1, int(max_inflight))
        self.ring = DispatchRing(depth=self.ring_depth)
        self._inflight: deque[_InFlight] = deque()
        #: one copy stream per CUDA device, made on its first stream dispatch
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}
        #: batches dispatched into the ring but not yet drained (an I-BATCH
        #: conservation term: injected == completed + queued + shed +
        #: in_flight); nonzero only while the streaming engine is feeding
        self.inflight_batches = 0
        self._t_first: float | None = None   # streaming window: first launch
        self._t_last = 0.0                   # ... -> last drain
        self.nts = dict(BUILTIN_COMPUTE_NTS)
        self.nts.update(nts or {})
        self.use_fused = (self.device.type == "cuda"
                          if use_fused is None else use_fused)
        self.deployments: dict[int, _Deployment] = {}
        # fair time sharing of the dispatch stream: per-tenant queues served
        # in WDRR order, cost = wire bytes (strict tenancy: injects for
        # unregistered tenants raise).  WDRR granularity: wire bytes of
        # deficit earned per round per unit weight.  Default ~ one MTU-sized
        # batch; set it near the typical batch wire size for the tightest
        # inter-tenant interleave.
        self.sched = FairScheduler(
            config=SchedConfig(quantum=float(quantum_bytes), strict=True),
            clock=time.perf_counter)
        self._order = 0                    # global inject sequence number
        #: (tenant, wire_bytes) per dispatched batch, in fair service order
        self.dispatch_log: list[tuple[str, float]] = []
        self._lat_s: dict[str, list[float]] = {}
        self._elapsed_s = 0.0
        self.stats = {"traces": 0, "dispatches": 0, "fused_dispatches": 0,
                      "batches": 0, "coalesced_batches": 0, "runs": 0,
                      "stream_batches": 0, "stream_epochs": 0}
        #: batches fully dispatched + synced (I-BATCH conservation: this +
        #: sched.pending() + shed_batches == stats["batches"])
        self.completed_batches = 0
        #: batches shed by backpressure or tenant churn (I-BATCH term)
        self.shed_batches = 0
        #: fault-injection switchboard (armed by a fault injector; None =
        #: zero-cost hooks)
        self.faults = None

    @property
    def tenants(self) -> dict[str, float]:
        return self.sched.weights

    def capacity(self) -> dict:
        """Capacity probe for a placer: nominal wire Gbps + device identity.
        Doubles as the health heartbeat — raises when crashed/hung, and a
        degraded shard reports its reduced rate."""
        if self.faults is not None:
            self.faults.check_probe()
        scale = self.faults.degrade if self.faults is not None else 1.0
        return {"gbps": scale * self.capacity_gbps,
                "device": str(self.devices[0]),
                "devices": [str(d) for d in self.devices]}

    # ----------------------------------------------------------- protocol --
    def register(self, spec: NTSpec) -> None:
        if spec.name not in self.nts:
            raise DagError(
                f"NT {spec.name!r} has no compute binding; register a "
                f"ComputeNT via register_nt() (have: {sorted(self.nts)})")

    def register_nt(self, nt: ComputeNT) -> None:
        self.nts[nt.name] = nt

    def add_tenant(self, tenant: str, weight: float) -> None:
        self.sched.add_tenant(tenant, weight)

    def remove_tenant(self, tenant: str) -> tuple[int, float]:
        """Tenant churn: drop the tenant's queue; shed batches are counted
        into the I-BATCH conservation term."""
        n, cost = self.sched.remove_tenant(tenant)
        self.shed_batches += n
        return n, cost

    def shed_backlog(self, tenant: str, cost_limit: float) -> tuple[int, float]:
        """Backpressure: cap one tenant's queued wire bytes (graceful
        degradation under fleet overload); counted, never silent."""
        n, cost = self.sched.shed_backlog(tenant, cost_limit)
        self.shed_batches += n
        return n, cost

    # ------------------------------------------------------------ compile --
    def _validate(self, dag: NTDag) -> None:
        for stage in dag.stages:
            writer: dict[str, tuple[int, str]] = {}
            for bi, branch in enumerate(stage):
                for name in branch:
                    if name not in self.nts:
                        raise DagError(f"NT {name!r} has no compute binding")
                    for fld in self.nts[name].writes:
                        prev = writer.get(fld)
                        if prev is not None and prev[0] != bi:
                            raise DagError(
                                f"parallel branches both write {fld!r} "
                                f"({prev[1]} and {name}); the join has no "
                                "ordering to merge them")
                        writer[fld] = (bi, name)

    def _composed_program(self, dag: NTDag) -> Callable:
        """Compose the DAG's NT functions into one program (the path for
        chains with no registered fused kernel)."""
        def program(state: dict, params: dict) -> dict:
            state = dict(state)
            orig_headers = state.get("headers")
            for stage in dag.stages:
                if len(stage) == 1:
                    for name in stage[0]:
                        state.update(self.nts[name].fn(
                            state, params.get(name, {})))
                    continue
                joined: dict = {}
                for branch in stage:              # fork: same input state
                    bstate = dict(state)
                    for name in branch:
                        up = self.nts[name].fn(bstate, params.get(name, {}))
                        bstate.update(up)
                        joined.update(up)
                state.update(joined)              # join: merge branch writes
            allow = state.get("allow")
            if allow is not None:                 # egress verdict
                if orig_headers is not None and "headers" in state:
                    state["headers"] = _select(allow, state["headers"],
                                               orig_headers)
                if "payload" in state:
                    state["payload"] = _select(allow, state["payload"], 0)
            return state

        return program

    def _get_program(self, dep: _Deployment, bucket: int,
                     path: str) -> Callable:
        """One cache slot per (deployment, bucket, path); a miss counts as
        a trace, so ``stats['traces']`` is the number of distinct buckets
        each deployment has dispatched."""
        key = (bucket, path)
        prog = dep.cache.get(key)
        if prog is None:
            self.stats["traces"] += 1
            prog = dep.fused if path == "fused" else dep.composed
            dep.cache[key] = prog
        return prog

    # ------------------------------------------------------------- deploy --
    def deploy(self, dag: NTDag, params: dict | None = None, **_kw) -> None:
        params = params or {}
        self._validate(dag)
        fused = None
        if self.use_fused:
            chain = _linear_chain(dag)
            factory = FUSED_KERNELS.get(chain) if chain else None
            if factory is not None:
                fused = factory(params)
        self.deployments[dag.uid] = _Deployment(
            dag, params, fused, self._composed_program(dag))

    def inject(self, tenant: str, dag_uid: int, state: dict | None = None,
               **fields) -> None:
        """Queue one packet batch on the tenant's fair-scheduler queue.
        ``state`` (or keyword fields) holds the batch tensors (numpy arrays
        are taken too), e.g. ``headers=(N, 5) u32, payload=(N, 16) u32``."""
        if dag_uid not in self.deployments:
            raise KeyError(f"DAG {dag_uid} not deployed")
        if tenant not in self.sched.queues:
            raise DagError(
                f"tenant {tenant!r} is not registered; call "
                "Platform.tenant(name, weight=...) (or add_tenant) before "
                "injecting — its weight decides its fair share")
        dep = self.deployments[dag_uid]
        if dep.dag.tenant != tenant:
            raise DagError(
                f"DAG {dag_uid} belongs to tenant {dep.dag.tenant!r}, not "
                f"{tenant!r}")
        batch = {k: _as_tensor(v) for k, v in (state or {}).items()}
        batch.update({k: _as_tensor(v) for k, v in fields.items()})
        if self.faults is not None:
            verdict = self.faults.gate_inject(tenant, dep.dag.all_nts())
            if verdict == "drop":
                return          # wire loss before the runtime; counted
            if verdict == "corrupt":
                batch = _corrupt_batch(batch, self.faults.rng)
        n = _rows(batch)
        for stage in dep.dag.stages:      # synthesize per-packet state (ctr)
            for branch in stage:
                for name in branch:
                    nt = self.nts.get(name)
                    if nt is None or nt.prep is None:
                        continue
                    if nt.stream is not None and \
                            dep.params.get(name, {}).get("stream"):
                        continue          # stream mode: assigned at dispatch
                    if nt.prep_fields and all(f in batch
                                              for f in nt.prep_fields):
                        continue          # caller supplied them all
                    with _batch_device(batch, self.device):
                        fields_ = nt.prep(n, dep.params.get(name, {}))
                    for k, v in fields_.items():
                        batch.setdefault(k, v)
        wire = sum(_nbytes(v) for k, v in batch.items()
                   if k in WIRE_FIELDS and isinstance(v, torch.Tensor))
        self._order += 1
        self.sched.submit(tenant, (self._order, dag_uid, batch),
                          cost=float(wire) if wire else float(max(n, 1)))
        self.stats["batches"] += 1

    def _stream_fields(self, dep: _Deployment, batch: dict) -> dict:
        """Dispatch-time synthesis for stream-mode NTs: advance the
        per-deployment running state and return the per-packet fields for
        this batch.  WDRR preserves per-tenant FIFO and a deployment
        belongs to one tenant, so dispatch order == inject order per
        stream."""
        out: dict = {}
        n = _rows(batch)
        for stage in dep.dag.stages:
            for branch in stage:
                for name in branch:
                    nt = self.nts.get(name)
                    if nt is None or nt.stream is None:
                        continue
                    p = dep.params.get(name, {})
                    if not p.get("stream"):
                        continue
                    if nt.prep_fields and all(f in batch
                                              for f in nt.prep_fields):
                        continue          # caller supplied them all
                    with _batch_device(batch, self.device):
                        fields, dep.nt_state[name] = nt.stream(
                            n, p, dep.nt_state.get(name, {}))
                    out.update(fields)
        return out

    # ------------------------------------------------- failover state I/O --
    def export_state(self, dag_uid: int) -> dict | None:
        """Snapshot one deployment's stream state (plain scalars) for the
        coordinator's checkpoint; None when the deployment is stateless."""
        dep = self.deployments.get(dag_uid)
        if dep is None or not dep.nt_state:
            return None
        return {nt: dict(st) for nt, st in dep.nt_state.items()}

    def import_state(self, dag_uid: int, state: dict) -> None:
        """Restore stream state on a failover target so the recovered
        deployment resumes bit-exact.  Values may arrive as 0-d arrays from
        a checkpoint restore; coerce back to plain ints."""
        def _scalar(v):
            try:
                return int(v)
            except (TypeError, ValueError):
                return v
        dep = self.deployments[dag_uid]
        dep.nt_state = {nt: {k: _scalar(v) for k, v in st.items()}
                        for nt, st in state.items()}

    def reset_window(self, keep_results: bool = False) -> None:
        """Start a fresh measurement window: clears the dispatch log and the
        latency monitors, and — unless ``keep_results`` — the accumulated
        per-deployment outputs together with the throughput window, so
        ``report()`` spans only subsequent ``run()`` calls (e.g. after a
        warmup pass that built the kernels).  With ``keep_results`` the
        elapsed window is kept too: Gbps is bytes-over-window, and the two
        must cover the same runs."""
        self.dispatch_log.clear()
        self._lat_s.clear()
        if not keep_results:
            self._elapsed_s = 0.0
            for dep in self.deployments.values():
                dep.results.clear()

    # ---------------------------------------------------------------- run --
    def _next_device(self) -> torch.device:
        """Round-robin device for the next dispatch group."""
        dev = self.devices[self._rr % len(self.devices)]
        self._rr += 1
        return dev

    def _fair_groups(self, entries: Iterable,
                     ) -> tuple[list, dict[int, tuple[str, float]]]:
        """Turn a fair service order into dispatch groups, coalescing
        *consecutive* same-DAG same-signature entries.  Stream-mode NT
        fields (the ChaCha ``ctr``) are assigned HERE, in deterministic fair
        order."""
        groups: list[tuple[tuple, list]] = []
        enq_at: dict[int, tuple[str, float]] = {}
        for tenant, item in entries:
            order, dag_uid, batch = item.payload
            sf = self._stream_fields(self.deployments[dag_uid], batch)
            if sf:
                batch = {**batch, **sf}
            self.dispatch_log.append((tenant, item.cost))
            enq_at[order] = (tenant, item.enqueued_at)
            key = (dag_uid, _signature(batch))
            if not groups or groups[-1][0] != key:
                groups.append((key, []))
            groups[-1][1].append((order, batch))
        return groups, enq_at

    def _launch(self, dep: _Deployment, batches: list[dict], bucket: int,
                state: dict) -> dict:
        """Common tail of the dispatch path: pick the path, call the
        program (it launches asynchronously on the current stream)."""
        path = ("fused" if dep.fused is not None
                and "allow" not in batches[0] else "composed")
        out = self._get_program(dep, bucket, path)(state, dep.params)
        self.stats["dispatches"] += 1
        if path == "fused":
            self.stats["fused_dispatches"] += 1
        return out

    def run(self, stream: bool | None = None, **_kw) -> None:
        """Service the tenant queues.  Batch mode (the default): drain in
        WDRR order, dispatch every batch asynchronously, synchronize with
        the device ONCE.  Stream mode (``stream=True``, or a backend built
        with ``stream=True``): the same fair order flows through the
        pipelined dispatch ring with a bounded in-flight window instead of
        a single end-of-run sync."""
        if stream is None:
            stream = self.stream
        if self.faults is not None and not self.faults.serving():
            return          # crashed/hung: queues keep their pending work
        if stream:
            self._run_stream()
            return
        t0 = time.perf_counter()
        # fair service order: the whole pending set, interleaved by weight
        groups, enq_at = self._fair_groups(self.sched.drain())

        launched = []
        used: set[torch.device] = set()
        for (dag_uid, _sig), entries in groups:
            dep = self.deployments[dag_uid]
            orders = [order for order, _ in entries]
            batches = [batch for _, batch in entries]
            sizes = [_rows(b) for b in batches]
            n = sum(sizes)
            bucket = bucket_size(n)
            if len(batches) > 1:
                self.stats["coalesced_batches"] += len(batches)
            dev = self._next_device()
            used.add(dev)
            state = {}
            for k, v in batches[0].items():
                if _is_array(v):
                    state[k] = _fill_bucket([b[k] for b in batches], bucket,
                                            dev)
                elif hasattr(v, "shape"):         # 0-d: fresh copy
                    state[k] = _pad_to(v, bucket, dev)
                else:
                    state[k] = v
            state["valid"] = torch.arange(bucket, device=dev) < n
            out = self._launch(dep, batches, bucket, state)
            launched.append((dep, orders, sizes, out))

        for dev in used:                          # the ONE sync (per device)
            if dev.type == "cuda":
                # once per device a run, after all its launches
                torch.cuda.synchronize(dev)  # noqa: L-HOSTSYNC
        t_done = time.perf_counter()
        self._elapsed_s += t_done - t0
        self.stats["runs"] += 1
        for tenant, t_enq in enq_at.values():   # inject -> sync completion
            self._lat_s.setdefault(tenant, []).append(t_done - t_enq)

        split = []                # un-coalesce, drop pad rows
        for dep, orders, sizes, out in launched:
            off = 0
            for order, s in zip(orders, sizes):
                split.append((order, dep, _slice_result(out, off, s)))
                off += s
        for _, dep, res in sorted(split, key=lambda t: t[0]):
            dep.results.append(res)       # results stay in inject order
        self.completed_batches += len(enq_at)
        if _sanitize.enabled():           # end-of-drain conservation audit
            _sanitize.check_compute(self, self.name)

    # ---------------------------------------------------- streaming engine --
    def _ship(self, slot: _RingSlot, dev: torch.device) -> dict:
        """Copy a filled slot to ``dev``.  On a CUDA device the copies run
        ``non_blocking`` from the pinned slot on the device's copy stream,
        into buffers allocated there and marked as used by the compute
        stream (so the caching allocator cannot hand them out again while
        the program still reads them); the compute stream waits on an
        event recorded after the copies.  On the CPU it is a plain copy."""
        if dev.type != "cuda":
            return {k: v.clone() for k, v in slot.staging.items()}
        copy = self._copy_streams.get(dev)
        if copy is None:
            copy = self._copy_streams[dev] = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(copy):
            # the ring slot's pinned staging, copied once a slot
            state = {k: v.to(dev, non_blocking=True)  # noqa: L-RING
                     for k, v in slot.staging.items()}
        for v in state.values():
            v.record_stream(compute)
        copied = torch.cuda.Event()
        copied.record(copy)
        compute.wait_event(copied)
        return state

    def _stage_group(self, dep: _Deployment, orders: list[int],
                     batches: list[dict],
                     enq: list[tuple[str, float]]) -> _InFlight:
        """Fill one ring slot with a dispatch group and launch it: the
        staging write is host-side (reused pinned buffers: zero
        steady-state allocations), the copy of the filled slot is the async
        host->device transfer that overlaps the previous group's kernel,
        and the program runs on the compute stream once the copy is in."""
        sizes = [_rows(b) for b in batches]
        n = sum(sizes)
        bucket = bucket_size(n)
        if len(batches) > 1:
            self.stats["coalesced_batches"] += len(batches)
        template = batches[0]
        fields = [(k, tuple(v.shape[1:]) if _is_array(v) else None, v.dtype)
                  for k, v in template.items()
                  if isinstance(v, torch.Tensor)]
        dev = self._next_device()
        ring_slot = self.ring.acquire(bucket, fields,
                                      pin=dev.type == "cuda")
        st = ring_slot.staging
        off = 0
        for b, m in zip(batches, sizes):
            for k, trail, _dt in fields:
                if trail is not None:
                    # host->host staging copy: inject batches are
                    # host-resident packet data (a device-resident batch
                    # is read back here, one sync per field)
                    st[k][off:off + m].copy_(b[k])
            off += m
        for k, trail, _dt in fields:
            if trail is None:
                st[k].copy_(template[k])      # 0-d: a stream counter base
            else:
                st[k][n:] = 0                 # pad rows (exact fill: noop)
        st["valid"][:n] = True
        st["valid"][n:] = False
        if self._t_first is None:
            self._t_first = time.perf_counter()   # streaming window opens
        state = self._ship(ring_slot, dev)        # async H2D of the slot
        for k, v in template.items():             # non-tensor fields
            state.setdefault(k, v)
        out = self._launch(dep, batches, bucket, state)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        self.inflight_batches += len(orders)
        self.stats["stream_batches"] += len(orders)
        return _InFlight(dep, orders, sizes, out, ring_slot, enq, done)

    def _retire(self, slot_entry: _InFlight) -> None:
        """Drain one ring entry: the ONLY per-slot sync (its completion
        event), taken when the bounded in-flight window wraps (or at the
        final flush).  Only now is its staging slot free again."""
        if slot_entry.done is not None:
            slot_entry.done.synchronize()
        t_done = time.perf_counter()
        self._t_last = t_done
        off = 0
        for order, s in zip(slot_entry.orders, slot_entry.sizes):
            # per-tenant FIFO + per-dep single tenant => retire order is
            # inject order for every deployment
            slot_entry.dep.results.append(
                _slice_result(slot_entry.out, off, s))
            off += s
        for tenant, t_enq in slot_entry.enq:      # inject -> slot drain
            self._lat_s.setdefault(tenant, []).append(t_done - t_enq)
        if slot_entry.slot is not None:
            self.ring.release(slot_entry.slot)
        self.completed_batches += len(slot_entry.orders)
        self.inflight_batches -= len(slot_entry.orders)

    def _stream_feed(self, entries: Iterable) -> int:
        """Push one fair service window through the dispatch ring: launch
        each group, retiring the oldest in-flight entry whenever the
        window exceeds ``max_inflight``; launches and drains interleave,
        so transfer and compute overlap across groups."""
        groups, enq_at = self._fair_groups(entries)
        for (dag_uid, _sig), group in groups:
            dep = self.deployments[dag_uid]
            orders = [order for order, _ in group]
            batches = [batch for _, batch in group]
            slot_entry = self._stage_group(
                dep, orders, batches, [enq_at[o] for o in orders])
            self._inflight.append(slot_entry)
            while len(self._inflight) > self.max_inflight:  # ring wrap
                self._retire(self._inflight.popleft())
        return len(enq_at)

    def _stream_flush(self) -> None:
        """Drain every in-flight ring entry and close the streaming
        throughput window (first-dispatch -> last-drain)."""
        while self._inflight:
            self._retire(self._inflight.popleft())
        if self._t_first is not None:
            self._elapsed_s += self._t_last - self._t_first
            self._t_first = None

    def _run_stream(self) -> None:
        """One streaming run: the current backlog, pipelined."""
        self._stream_feed(self.sched.drain())
        self._stream_flush()
        self.stats["runs"] += 1
        if _sanitize.enabled():
            _sanitize.check_compute(self, self.name)

    def inject_stream(self, source: Iterable | Iterator, *,
                      epoch_cost: float | None = None,
                      epoch_batches: int | None = None) -> int:
        """Continuous-inject streaming: service a live inject ``source``
        epoch-by-epoch instead of draining a static backlog.

        ``source`` yields ``(tenant, dag_uid, state_dict)`` triples.  Each
        epoch ingests up to ``epoch_batches`` (default: the ring depth)
        fresh injects, asks the scheduler for one stream-credit window
        (:meth:`FairScheduler.stream_window`: WDRR order, at most
        ``epoch_cost`` wire bytes; ``None`` = the whole backlog), and feeds
        the granted work through the dispatch ring.  In-flight entries
        carry across epochs; the final flush drains them and closes the
        throughput window.  Returns the number of batches serviced."""
        per_epoch = self.ring_depth if epoch_batches is None \
            else max(1, int(epoch_batches))
        it = iter(source)
        exhausted = False
        served = 0
        while not exhausted or self.sched.pending():
            if self.faults is not None and not self.faults.gate_stream():
                break       # mid-stream fault: backlog stays queued/journaled
            for _ in range(per_epoch):
                try:
                    tenant, dag_uid, st = next(it)
                except StopIteration:
                    exhausted = True
                    break
                self.inject(tenant, dag_uid, state=st)
            served += self._stream_feed(self.sched.stream_window(epoch_cost))
            self.stats["stream_epochs"] += 1
        self._stream_flush()
        self.stats["runs"] += 1
        if _sanitize.enabled():
            _sanitize.check_compute(self, self.name)
        return served

    # ------------------------------------------------------------- report --
    def report(self) -> PlatformReport:
        rep = PlatformReport(backend=self.name,
                             duration_ns=self._elapsed_s * 1e9)
        rep.extra["compiles"] = self.stats["traces"]
        rep.extra.update(self.stats)
        rep.extra["ring"] = self.ring.stats()
        rep.extra["ring"]["max_inflight"] = self.max_inflight
        rep.extra["inflight_batches"] = self.inflight_batches
        sched_mon = self.sched.snapshot()
        for dep in self.deployments.values():
            tenant = dep.dag.tenant
            tr = rep.tenants.setdefault(
                tenant, TenantReport(tenant=tenant, backend=self.name))
            for out in dep.results:
                n = _rows(out)
                # throughput counts wire fields only: verdict bits, counters
                # and scratch fields are not packet bytes
                nbytes = sum(_nbytes(v) for k, v in out.items()
                             if k in WIRE_FIELDS
                             and isinstance(v, torch.Tensor))
                tr.pkts_done += n
                tr.bytes_done += nbytes
                tr.outputs.append(out)
            if self._elapsed_s > 0:
                tr.gbps = tr.bytes_done * 8 / self._elapsed_s / 1e9
        # scheduler-side accounting: weight, fair-served wire bytes, and
        # inject->sync batch latencies
        for tenant, tr in rep.tenants.items():
            mon = sched_mon.get(tenant)
            if mon is not None:
                tr.extra["weight"] = mon["weight"]
                tr.extra["sched_served_bytes"] = mon["served_cost"]
            lats = sorted(self._lat_s.get(tenant, ()))
            if lats:
                tr.mean_latency_us = sum(lats) / len(lats) * 1e6
                tr.p99_latency_us = lats[
                    min(len(lats) - 1, int(0.99 * len(lats)))] * 1e6
        return rep


__all__ = ["BUILTIN_COMPUTE_NTS", "ComputeBackend", "ComputeNT",
           "DispatchRing", "FUSED_KERNELS", "VPC_SPECS", "WIRE_FIELDS",
           "bucket_size", "GBPS"]
