"""Admission verifier: static checks on an :class:`NTDag` before it touches
a shard (the paper's "efficiently *and safely*" claim, §3).

``verify(dag, tenant, backend, specs)`` returns diagnostics in three rule
families, each with a stable id the fixture corpus pins down:

Structure
  - **V-ARITY**: malformed stage/branch arity — empty DAG, a stage with no
    branches, a branch with no NTs, non-string NT names.
  - **V-CYCLE**: an NT re-entered after it already ran — repeated inside a
    branch, or appearing again in a later stage.  The stage form is a
    topological order, so re-entry is exactly a back edge.
  - **V-UNREACHABLE**: stages downstream of an empty stage; no packet can
    ever fork into zero branches, so everything after it is dead.

Signatures (needs a compute binding table, ``backend.nts``)
  - **V-SIGNATURE**: dataflow along every edge — an NT reading a field no
    ingress source or upstream NT produces; two parallel branches that both
    write one field (the join has no ordering to merge them); a reader whose
    declared trailing shape/dtype disagrees with the upstream writer's.

Resources & isolation (needs an :class:`NTSpec` registry)
  - **V-BUDGET-VMEM** (error): the per-block shared-memory footprint of a
    fused branch (sum of per-NT ``tile_bytes``) exceeds
    :data:`repro_torch.core.vmem.VMEM_BUDGET_BYTES`, the shared memory one
    thread block may use — the kernel could not launch.
  - **V-BUDGET-STATE** (warning): total NT ``state_bytes`` oversubscribes
    the backend's on-board memory.  Paged vmem makes this legal (it swaps),
    so it warns about thrash instead of rejecting.
  - **V-CAPACITY** (warning): the chain's bottleneck NT rate is below the
    backend's declared ``capacity_gbps`` — worst-case per-packet work can
    never fill the provisioned line.
  - **V-ISOLATION** (error): the DAG references a *stateful* NT
    (``state_bytes > 0``) already deployed by a different tenant, and the
    spec is not declared ``shared`` — the §3 cross-tenant state rule.

Severity decides strictness: errors reject a strict deploy, warnings never
do, so every well-formed existing DAG keeps admitting while the warn
channel surfaces provisioning smells.
"""
from __future__ import annotations

from repro_torch.api.dag import DagError
from repro_torch.core.nt import NTDag, NTSpec
from repro_torch.core.vmem import VMEM_BUDGET_BYTES

from .diagnostics import Diagnostic, Severity, render_text, sort_diags

#: batch fields the runtime itself provides at ingress (see ComputeBackend:
#: inject supplies the wire fields, run() synthesizes the validity mask)
INGRESS_FIELDS = ("headers", "payload", "valid")

#: fallback on-board state budget when the backend exposes no vmem sizing
DEFAULT_STATE_BUDGET_BYTES = 64 << 20

SWAP_US = 17.5   # mirrors core.vmem.SWAP_NS, for the V-BUDGET-STATE message


class AdmissionError(DagError):
    """A strict-mode deploy rejected by the admission verifier.

    Subclasses :class:`DagError` so existing ``except DagError`` admission
    handling keeps working; carries the full structured ``diagnostics``
    list (errors *and* warnings) for programmatic consumers.
    """

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__("admission rejected:\n" + render_text(self.diagnostics))


def verify(dag: NTDag, tenant: str | None = None, backend=None,
           specs: dict[str, NTSpec] | None = None) -> list[Diagnostic]:
    """Statically verify ``dag`` for admission; returns all diagnostics
    (empty means clean).  ``backend`` and ``specs`` are optional — rules
    that need them are skipped when absent, so the structural pass runs on
    a bare NTDag."""
    tenant = tenant if tenant is not None else dag.tenant
    diags: list[Diagnostic] = []
    well_formed = _check_structure(dag, tenant, diags)
    nts = _compute_bindings(backend)
    if well_formed and nts:
        _check_signatures(dag, tenant, nts, diags)
        _check_vmem_tiles(dag, tenant, nts, diags)
    if well_formed and specs:
        _check_state_budget(dag, tenant, specs, backend, diags)
        _check_capacity(dag, tenant, specs, backend, diags)
        _check_isolation(dag, tenant, specs, backend, diags)
    return sort_diags(diags)


def admit(dag: NTDag, tenant: str | None = None, backend=None,
          specs: dict[str, NTSpec] | None = None,
          strict: bool = True) -> list[Diagnostic]:
    """Verify and gate: in strict mode any error-severity diagnostic raises
    :class:`AdmissionError`; warn-only mode always returns the list."""
    diags = verify(dag, tenant, backend, specs)
    if strict and any(d.severity == Severity.ERROR for d in diags):
        raise AdmissionError(diags)
    return diags


# ---------------------------------------------------------------- structure --
def _subj(tenant: str, dag: NTDag, stage: int | None = None,
          branch: int | None = None) -> str:
    s = f"dag:{tenant}/{dag.uid}"
    if stage is not None:
        s += f"/stage{stage}"
    if branch is not None:
        s += f"/branch{branch}"
    return s


def _check_structure(dag: NTDag, tenant: str,
                     diags: list[Diagnostic]) -> bool:
    """V-ARITY / V-CYCLE / V-UNREACHABLE.  Returns False when the DAG is so
    malformed the downstream passes cannot walk it."""
    ok = True
    if not dag.stages:
        diags.append(Diagnostic(
            "V-ARITY", Severity.ERROR, _subj(tenant, dag),
            "DAG has no stages",
            hint="build with nt(...) >> nt(...); an empty DAG does no work"))
        return False
    dead_after: int | None = None
    seen_upstream: set[str] = set()
    for si, stage in enumerate(dag.stages):
        if dead_after is not None:
            diags.append(Diagnostic(
                "V-UNREACHABLE", Severity.ERROR, _subj(tenant, dag, si),
                f"stage {si} is unreachable: stage {dead_after} has no "
                "branches, so no packet ever reaches it",
                hint="delete the empty stage or the dead tail"))
            continue
        if not isinstance(stage, tuple) or not stage:
            diags.append(Diagnostic(
                "V-ARITY", Severity.ERROR, _subj(tenant, dag, si),
                f"stage {si} has no branches (fork arity 0)",
                hint="every stage needs at least one branch"))
            dead_after = si
            ok = False
            continue
        stage_names: set[str] = set()
        for bi, branch in enumerate(stage):
            if not isinstance(branch, tuple) or not branch:
                diags.append(Diagnostic(
                    "V-ARITY", Severity.ERROR, _subj(tenant, dag, si, bi),
                    f"branch {bi} of stage {si} is empty (join arity "
                    "mismatch: the sync buffer would wait on a branch that "
                    "never produces)",
                    hint="every branch needs at least one NT"))
                ok = False
                continue
            for name in branch:
                if not isinstance(name, str) or not name:
                    diags.append(Diagnostic(
                        "V-ARITY", Severity.ERROR,
                        _subj(tenant, dag, si, bi),
                        f"branch {bi} of stage {si} holds a non-NT entry "
                        f"{name!r}",
                        hint="branches are tuples of NT name strings"))
                    ok = False
                    continue
                if branch.count(name) > 1:
                    if name in stage_names:      # report each dup NT once
                        continue
                    diags.append(Diagnostic(
                        "V-CYCLE", Severity.ERROR,
                        _subj(tenant, dag, si, bi),
                        f"NT {name!r} repeats inside branch {branch}: the "
                        "chain re-enters an NT it already ran (back edge)",
                        hint="a chain program instantiates each NT once; "
                             "split the loop body into distinct NTs"))
                    ok = False
                elif name in seen_upstream:
                    diags.append(Diagnostic(
                        "V-CYCLE", Severity.ERROR,
                        _subj(tenant, dag, si, bi),
                        f"NT {name!r} in stage {si} already ran in an "
                        "earlier stage: the stage order is topological, so "
                        "re-entry is a cycle",
                        hint="duplicate the task under a new NT name if the "
                             "DAG genuinely needs it twice"))
                    ok = False
                stage_names.add(name)
        seen_upstream |= stage_names
    return ok


# --------------------------------------------------------------- signatures --
def _compute_bindings(backend) -> dict | None:
    """The backend's ComputeNT table, if it has one (duck-typed; a sharded
    backend exposes its shards' tables merged)."""
    nts = getattr(backend, "nts", None)
    if isinstance(nts, dict) and nts:
        return nts
    merged: dict = {}
    for shard in getattr(backend, "shards", ()) or ():
        sub = _compute_bindings(shard)
        if sub:
            merged.update(sub)
    return merged or None


def _schema_of(nt) -> dict[str, tuple]:
    """ComputeNT.schema tuples -> {field: (trailing_shape, dtype)}."""
    return {f: (tuple(shape), dtype)
            for f, shape, dtype in getattr(nt, "schema", ()) or ()}


def _check_signatures(dag: NTDag, tenant: str, nts: dict,
                      diags: list[Diagnostic]) -> None:
    """V-SIGNATURE: reads satisfied, join writes conflict-free, shapes
    agree along every producing edge."""
    # prep-synthesized fields (e.g. the chacha ctr) exist from ingress on
    available = set(INGRESS_FIELDS)
    for name in dag.all_nts():
        available |= set(getattr(nts.get(name), "prep_fields", ()) or ())
    field_src: dict[str, tuple[str, tuple, str]] = {}   # fld -> (nt, shape, dt)

    for si, stage in enumerate(dag.stages):
        stage_writes: set[str] = set()
        writer: dict[str, tuple[int, str]] = {}
        for bi, branch in enumerate(stage):
            branch_avail = set(available)
            for name in branch:
                nt = nts.get(name)
                if nt is None:
                    continue       # no binding: the backend rejects itself
                schema = _schema_of(nt)
                for fld in getattr(nt, "reads", ()) or ():
                    if fld not in branch_avail:
                        diags.append(Diagnostic(
                            "V-SIGNATURE", Severity.ERROR,
                            _subj(tenant, dag, si, bi),
                            f"NT {name!r} reads field {fld!r} that no "
                            "ingress source or upstream NT produces",
                            hint="add a producer upstream or supply the "
                                 "field at inject time"))
                        continue
                    src = field_src.get(fld)
                    want = schema.get(fld)
                    if src and want and (src[1], src[2]) != want:
                        diags.append(Diagnostic(
                            "V-SIGNATURE", Severity.ERROR,
                            _subj(tenant, dag, si, bi),
                            f"shape break on edge {src[0]} -> {name}: "
                            f"{name!r} reads {fld!r} as "
                            f"{want[1]}{list(want[0])} but {src[0]!r} "
                            f"produces {src[2]}{list(src[1])}",
                            hint="align the field schemas or insert a "
                                 "reshaping NT between them"))
                for fld in getattr(nt, "writes", ()) or ():
                    prev = writer.get(fld)
                    if prev is not None and prev[0] != bi:
                        diags.append(Diagnostic(
                            "V-SIGNATURE", Severity.ERROR,
                            _subj(tenant, dag, si),
                            f"parallel branches both write {fld!r} "
                            f"({prev[1]} and {name}); the join has no "
                            "ordering to merge them",
                            hint="route the writes to distinct fields, or "
                                 "serialize the branches with >>"))
                    writer[fld] = (bi, name)
                    branch_avail.add(fld)
                    stage_writes.add(fld)
                    if fld in schema:
                        shape, dtype = schema[fld]
                        field_src[fld] = (name, shape, dtype)
        available |= stage_writes


# ---------------------------------------------------------------- resources --
def _check_vmem_tiles(dag: NTDag, tenant: str, nts: dict,
                      diags: list[Diagnostic]) -> None:
    """V-BUDGET-VMEM: a branch fuses into one kernel (one region / one
    CUDA kernel), so its summed tile footprint must fit the shared memory
    of one thread block."""
    for si, stage in enumerate(dag.stages):
        for bi, branch in enumerate(stage):
            tile = sum(int(getattr(nts.get(n), "tile_bytes", 0) or 0)
                       for n in branch)
            if tile > VMEM_BUDGET_BYTES:
                diags.append(Diagnostic(
                    "V-BUDGET-VMEM", Severity.ERROR,
                    _subj(tenant, dag, si, bi),
                    f"fused branch {branch} needs {tile} B of shared-memory "
                    f"tile residency, over the {VMEM_BUDGET_BYTES} B "
                    "per-block budget",
                    hint="shrink the kernels' tiles or split the branch "
                         "into stages so each fuses separately"))


def _state_budget_bytes(backend) -> int:
    """On-board state budget: the backend's vmem sizing where exposed
    (``vmem`` attr on the backend, its device, or any shard), else the
    default."""
    seen = []
    stack = [backend]
    while stack:
        b = stack.pop()
        if b is None or id(b) in seen:
            continue
        seen.append(id(b))
        vm = getattr(b, "vmem", None)
        if vm is not None and hasattr(vm, "n_frames"):
            return int(vm.n_frames * vm.page_bytes)
        for attr in ("snic", "snics", "shards"):
            sub = getattr(b, attr, None)
            if sub is None:
                continue
            stack.extend(sub if isinstance(sub, (list, tuple)) else [sub])
    return DEFAULT_STATE_BUDGET_BYTES


def _check_state_budget(dag: NTDag, tenant: str, specs: dict[str, NTSpec],
                        backend, diags: list[Diagnostic]) -> None:
    """V-BUDGET-STATE (warning): paged vmem swaps rather than faults, so
    oversubscription admits — but it will thrash, and the tenant should
    hear it at deploy time, not discover it in a latency histogram."""
    total = sum(specs[n].state_bytes for n in set(dag.all_nts())
                if n in specs)
    budget = _state_budget_bytes(backend)
    if total > budget:
        diags.append(Diagnostic(
            "V-BUDGET-STATE", Severity.WARNING, _subj(tenant, dag),
            f"DAG NT state totals {total} B, oversubscribing the "
            f"{budget} B on-board budget; pages will swap "
            f"(~{SWAP_US:.1f} us each)",
            hint="shrink state_bytes, raise the vmem size, or accept "
                 "swap latency"))


def _capacity_gbps(backend) -> float | None:
    """The backend's declared line rate: a ``capacity_gbps`` float, a
    per-shard list (use the fastest shard — the placer may route there), or
    a ``capacity()`` probe dict."""
    cap = getattr(backend, "capacity_gbps", None)
    if isinstance(cap, (list, tuple)):
        cap = max(cap) if cap else None
    if cap is None:
        probe = getattr(backend, "capacity", None)
        if callable(probe):
            try:
                cap = probe().get("gbps")
            except Exception:
                cap = None
    return float(cap) if cap else None


def _check_capacity(dag: NTDag, tenant: str, specs: dict[str, NTSpec],
                    backend, diags: list[Diagnostic]) -> None:
    """V-CAPACITY (warning): worst-case per-packet work — the slowest NT on
    the slowest branch bounds the whole chain's rate."""
    cap = _capacity_gbps(backend)
    if not cap:
        return
    rates = [specs[n].max_gbps for n in dag.all_nts() if n in specs]
    if not rates:
        return
    bottleneck = min(rates)
    slowest = min((n for n in dag.all_nts() if n in specs),
                  key=lambda n: specs[n].max_gbps)
    if bottleneck < cap:
        diags.append(Diagnostic(
            "V-CAPACITY", Severity.WARNING, _subj(tenant, dag),
            f"chain bottleneck {slowest!r} tops out at {bottleneck:g} Gbps, "
            f"below the backend's declared capacity {cap:g} Gbps — "
            "worst-case per-packet work can never fill the line",
            hint="scale the bottleneck NT out (more instances) or "
                 "provision capacity_gbps to the chain's real rate"))


# ---------------------------------------------------------------- isolation --
def _deployed_dags(backend) -> list[NTDag]:
    """Every NTDag already deployed on the backend (duck-typed across sim,
    compute, serve and sharded backends; recurses into shards)."""
    out: list[NTDag] = []
    seen: set[int] = set()
    stack = [backend]
    while stack:
        b = stack.pop()
        if b is None or id(b) in seen:
            continue
        seen.add(id(b))
        deps = getattr(b, "deployments", None)
        if isinstance(deps, dict):
            for d in deps.values():
                dag = getattr(d, "dag", d)
                if isinstance(dag, NTDag):
                    out.append(dag)
        dags = getattr(b, "dags", None)
        if isinstance(dags, dict):
            out.extend(d for d in dags.values() if isinstance(d, NTDag))
        for attr in ("snic", "snics", "shards"):
            sub = getattr(b, attr, None)
            if sub is None:
                continue
            stack.extend(sub if isinstance(sub, (list, tuple)) else [sub])
    return out


def _check_isolation(dag: NTDag, tenant: str, specs: dict[str, NTSpec],
                     backend, diags: list[Diagnostic]) -> None:
    """V-ISOLATION: NT state tables are keyed by NT name, so two tenants
    deploying the same stateful NT would read/write one table — the §3
    violation — unless the spec opts in with ``shared=True``."""
    owners: dict[str, str] = {}
    for other in _deployed_dags(backend):
        if other.tenant == tenant:
            continue
        for name in other.all_nts():
            owners.setdefault(name, other.tenant)
    for name in dict.fromkeys(dag.all_nts()):     # stable order, deduped
        spec = specs.get(name)
        if spec is None or spec.state_bytes <= 0:
            continue
        if getattr(spec, "shared", False):
            continue
        owner = owners.get(name)
        if owner is not None:
            diags.append(Diagnostic(
                "V-ISOLATION", Severity.ERROR, _subj(tenant, dag),
                f"NT {name!r} carries {spec.state_bytes} B of state "
                f"already owned by tenant {owner!r}; cross-tenant state "
                "access breaks isolation (§3)",
                hint="declare the NTSpec shared=True if the state is "
                     "genuinely common, or deploy a per-tenant NT name"))


__all__ = ["AdmissionError", "DEFAULT_STATE_BUDGET_BYTES", "INGRESS_FIELDS",
           "admit", "verify"]
