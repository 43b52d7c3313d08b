"""The Platform facade: one tenant-facing offload API over every substrate.

This is the repo's analogue of SuperNIC's user interface (§3): a tenant
registers NTs, declares a network-task DAG with the builder, deploys it,
injects traffic, and reads typed per-tenant results — without caring whether
the DAG lands on a GPU kernel, the LLM serving engine, or a fleet of
shards.  In the port the compute and serving substrates exist so far, and
a list of compute backends makes a fleet::

    from repro_torch.api import ComputeBackend, Platform, VPC_SPECS, nt

    plat = Platform(ComputeBackend(), specs=VPC_SPECS)    # cuda:0
    ten = plat.tenant("alice", weight=2.0)
    dep = ten.deploy(nt("firewall") >> nt("nat") >> nt("chacha20"),
                     params=params)
    ten.inject(headers=headers, payload=payload)   # (N, 5), (N, 16) u32
    plat.run()
    print(plat.report()["alice"].gbps)

    from repro_torch.api import SERVE_SPECS, ServeBackend
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig

    plat = Platform(ServeBackend(get_config("qwen3-8b"), EngineConfig()),
                    specs=SERVE_SPECS)                    # cuda:0
    dep = plat.tenant("gold", weight=2.0).deploy(
        nt("cache") >> nt("prefill") >> nt("decode"))
    dep.inject(prompt, max_new=16)                 # (S,) int32 token ids
    plat.run()

    plat = Platform([ComputeBackend(name="c0", stream=True),
                     ComputeBackend(name="c1", device=1, stream=True)],
                    specs=VPC_SPECS)                  # a ShardedBackend
    plat.drive(trace)                              # a workloads.Trace
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.nt import NTDag, NTSpec

from .backend import Backend, PlatformReport, TenantReport
from .dag import DagError, DagExpr, compile_dag


@dataclass
class Deployment:
    """Handle for one deployed DAG (uid + compiled stages)."""
    dag: NTDag
    tenant: "Tenant"

    @property
    def uid(self) -> int:
        return self.dag.uid

    def inject(self, *args, **kw):
        return self.tenant.platform.backend.inject(
            self.tenant.name, self.dag.uid, *args, **kw)

    def source(self, kind: str = "poisson", **kw) -> None:
        """Attach a stochastic traffic source (sim backend only)."""
        backend = self.tenant.platform.backend
        if not hasattr(backend, "add_source"):
            raise NotImplementedError(
                f"{backend.name} backend has no traffic sources")
        backend.add_source(kind, self.tenant.name, self.dag.uid, **kw)


@dataclass
class Tenant:
    """A tenant handle: deploys DAGs and injects traffic under its name."""
    platform: "Platform"
    name: str
    weight: float = 1.0
    deployments: list[Deployment] = field(default_factory=list)

    def deploy(self, dag: DagExpr | NTDag | str,
               strict: bool | None = None, **kw) -> Deployment:
        """Compile + validate a builder expression, run it through the
        admission verifier, and hand it to the backend.  Backend-specific
        keywords pass through (``params=`` for compute, ``prelaunch=`` for
        sim).  ``strict`` overrides the platform-wide admission mode for
        this deploy: strict admission raises
        :class:`~repro_torch.analysis.verifier.AdmissionError` on any
        error-severity diagnostic; warn-only admission records everything
        in ``platform.admission_log`` and deploys anyway."""
        # local import: repro_torch.analysis imports repro_torch.api.dag at module
        # level, so importing it here (not at module scope) breaks the cycle
        from repro_torch.analysis.verifier import admit
        ntdag = compile_dag(
            dag, uid=self.platform._next_uid(), tenant=self.name,
            specs=self.platform.specs or None,
            region_slots=getattr(self.platform.backend, "region_slots", None))
        diags = admit(
            ntdag, self.name, backend=self.platform.backend,
            specs=self.platform.specs or None,
            strict=self.platform.strict if strict is None else strict)
        self.platform.admission_log.extend(diags)
        self.platform.backend.deploy(ntdag, **kw)
        dep = Deployment(ntdag, self)
        self.deployments.append(dep)
        return dep

    def inject(self, *args, dag: Deployment | None = None, **kw):
        """Inject traffic into this tenant's (sole, or given) deployment."""
        if dag is None:
            if len(self.deployments) != 1:
                raise DagError(
                    f"tenant {self.name!r} has {len(self.deployments)} "
                    "deployments; pass dag=<deployment>")
            dag = self.deployments[0]
        return dag.inject(*args, **kw)

    def report(self) -> TenantReport:
        rep = self.platform.report()
        return rep.tenants.get(
            self.name, TenantReport(tenant=self.name,
                                    backend=self.platform.backend.name))


class Platform:
    """Facade over one backend; owns the NT-spec registry and tenant set.

    Pass a *list* of backends to fan the platform across a shard fleet:
    ``Platform([ComputeBackend(name="c0"), ComputeBackend(name="c1")])``
    wraps them in a :class:`~repro_torch.api.sharded_backend.ShardedBackend`,
    so deploys are routed by consolidation-driven placement and tenants are
    scheduled by the cross-shard fair epoch instead of a single backend.
    """

    def __init__(self, backend: Backend | list[Backend] | tuple,
                 specs: dict[str, NTSpec] | list[NTSpec] | None = None,
                 strict: bool = True):
        if isinstance(backend, (list, tuple)):
            from .sharded_backend import ShardedBackend
            backend = ShardedBackend(list(backend))
        self.backend = backend
        self.specs: dict[str, NTSpec] = {}
        self.tenants: dict[str, Tenant] = {}
        self._uid = 0
        #: admission mode: strict deploys reject on error diagnostics;
        #: strict=False is the warn-only migration mode — everything the
        #: verifier finds lands in ``admission_log`` either way
        self.strict = strict
        self.admission_log: list = []
        if specs:
            vals = specs.values() if isinstance(specs, dict) else specs
            self.register(*vals)

    def _next_uid(self) -> int:
        self._uid += 1
        return self._uid

    def register(self, *specs: NTSpec) -> "Platform":
        """Register NT specs: build-time validation vocabulary + whatever
        the backend needs (sim service models, kernel-binding checks)."""
        for spec in specs:
            self.specs[spec.name] = spec
            self.backend.register(spec)
        return self

    def tenant(self, name: str, weight: float | None = None) -> Tenant:
        """Get-or-create a tenant handle.  ``weight`` given on a repeat call
        *updates* the tenant's weight and propagates it to the backend's
        scheduler(s) — on a sharded backend, to every shard's FairScheduler
        — instead of being silently ignored; omit ``weight`` to fetch the
        handle without touching the current weight."""
        t = self.tenants.get(name)
        if t is None:
            t = Tenant(self, name, 1.0 if weight is None else weight)
            self.tenants[name] = t
            self.backend.add_tenant(name, t.weight)
        elif weight is not None and weight != t.weight:
            t.weight = weight
            self.backend.add_tenant(name, weight)
        return t

    def run(self, **kw) -> None:
        self.backend.run(**kw)

    def drive(self, trace, **driver_kw):
        """Replay a :class:`repro_torch.workloads.Trace` onto this platform
        and return the :class:`repro_torch.workloads.DriveResult` — the
        one-call path from a sealed scenario to per-tenant counters.
        Keyword arguments pass through to
        :class:`repro_torch.workloads.TraceDriver` (``params=``,
        ``chain_map=``, ``max_new=``)."""
        # local import: the workload plane imports repro_torch.api for the
        # DAG builder, so importing it lazily here breaks the cycle
        from repro_torch.workloads import TraceDriver
        return TraceDriver(self, **driver_kw).drive(trace)

    def report(self) -> PlatformReport:
        return self.backend.report()
