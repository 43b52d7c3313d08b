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

The streaming dispatch ring (``stream=True``, ``run(stream=True)``,
``inject_stream``) is the next slice of the port (ROADMAP Queue 1 #7); here
it raises ``NotImplementedError``.

Fork/join semantics mirror the sync buffer (§4.2): every branch of a stage
reads the stage's input state; the join merges each branch's declared
``writes``.  Two branches writing the same field is a build-time error.

Egress applies the firewall verdict the way the fixed sNIC datapath does:
denied packets keep their original header and leave with a zeroed payload
(bit-exact with ``vpc_chain``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch import _device
from repro_torch._u32 import MASK, arange32, narrow, where32
from repro_torch.analysis import invariants as _sanitize
from repro_torch.core.nt import GBPS, NTDag, NTSpec
from repro_torch.core.sched import FairScheduler, SchedConfig
from repro_torch.kernels.chacha20.ops import smem_tile_bytes as _chacha_tile
from repro_torch.kernels.vpc_datapath import vpc_datapath
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

_STREAM_LATER = ("the streaming dispatch ring is not ported yet: "
                 "ROADMAP Queue 1 #7")


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
    backend's device as PyTorch's default device.  ``prep_fields`` names
    them, so inject can skip ``prep`` when the caller already supplied every
    one.

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
    deploy-time params are only a capability probe — every param is re-read
    from the runtime params argument, the same binding the composed path
    gives every NT."""
    try:
        params["firewall"]["rules"]
        params["chacha20"]["key"]
        params["chacha20"]["nonce"]
    except (KeyError, TypeError):
        return None

    def program(state: dict, params: dict) -> dict:
        ch = params["chacha20"]
        allow, hout, pout = vpc_datapath(
            state["headers"], state["payload"], params["firewall"]["rules"],
            ch["key"], ch["nonce"],
            nat_ip=params.get("nat", {}).get("nat_ip", 0x0A000001),
            counter0=state.get("ctr0", ch.get("counter0", 1)),
            ctr=state.get("ctr"))
        return {**state, "allow": allow, "headers": hout, "payload": pout}

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
                 capacity_gbps: float = 100.0, stream: bool = False):
        """``device``: where batches run — ``None`` is ``cuda:0`` (and raises
        where no GPU is present: pass ``device="cpu"`` for the plain
        PyTorch path on the CPU), an int is a CUDA ordinal, or a string /
        ``torch.device``.  A *list* of devices round-robins this shard's
        dispatch groups across them.  ``capacity_gbps`` is the nominal
        wire capacity a placer provisions against.  ``use_fused`` defaults
        to True on a CUDA device."""
        if stream:
            raise NotImplementedError(_STREAM_LATER)
        if name is not None:
            self.name = name
        devs = list(device) if isinstance(device, (list, tuple)) \
            else [device]
        self.devices = [_device.resolve(d) for d in devs]
        self.device = self.devices[0]
        self._rr = 0                       # round-robin device cursor
        self.capacity_gbps = capacity_gbps
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
                      "batches": 0, "coalesced_batches": 0, "runs": 0}
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
                    with self.device:
                        fields_ = nt.prep(n, dep.params.get(name, {}))
                    for k, v in fields_.items():
                        batch.setdefault(k, v)
        wire = sum(_nbytes(v) for k, v in batch.items()
                   if k in WIRE_FIELDS and isinstance(v, torch.Tensor))
        self._order += 1
        self.sched.submit(tenant, (self._order, dag_uid, batch),
                          cost=float(wire) if wire else float(max(n, 1)))
        self.stats["batches"] += 1

    def inject_stream(self, *_a, **_kw) -> int:
        raise NotImplementedError(_STREAM_LATER)

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
                    with self.device:
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

    def run(self, stream: bool = False, **_kw) -> None:
        """Service the tenant queues: drain in WDRR order, dispatch every
        batch asynchronously, synchronize with the device ONCE."""
        if stream:
            raise NotImplementedError(_STREAM_LATER)
        if self.faults is not None and not self.faults.serving():
            return          # crashed/hung: queues keep their pending work
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
                torch.cuda.synchronize(dev)
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

    # ------------------------------------------------------------- report --
    def report(self) -> PlatformReport:
        rep = PlatformReport(backend=self.name,
                             duration_ns=self._elapsed_s * 1e9)
        rep.extra["compiles"] = self.stats["traces"]
        rep.extra.update(self.stats)
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
           "FUSED_KERNELS", "VPC_SPECS", "WIRE_FIELDS", "bucket_size",
           "GBPS"]
