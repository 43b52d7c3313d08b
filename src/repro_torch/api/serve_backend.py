"""ServeBackend: the Platform face of the multi-tenant LLM serving engine.

The serving substrate executes one canonical request chain —
``cache >> prefill >> decode`` (the paper's caching NT in front of the
model, §6.1) — so deployment here means *configuring* that chain: a DAG
without the ``cache`` NT turns the response cache off for the engine.
``inject`` submits token prompts; the report carries finished requests with
per-tenant latency and cache-hit statistics.  The engine runs on ``cuda:0``
unless given ``device="cpu"``; nothing here depends on the model family
(dense, MoE or hybrid Mamba).  On the card, prefill attention, the MoE
expert matmuls and the Mamba scans go through hand-written CUDA kernels.
"""
from __future__ import annotations

from repro_torch.core.nt import NTDag, NTSpec

from .backend import PlatformReport, TenantReport
from .dag import DagError

# nominal service models so the same names validate on the sim substrate
SERVE_SPECS: dict[str, NTSpec] = {
    # the response cache is ONE engine-wide pool every tenant's chain reads
    # through — stateful, and deliberately shared (the verifier's
    # V-ISOLATION rule exempts shared=True specs)
    "cache": NTSpec("cache", max_gbps=100.0, fixed_ns=200.0,
                    state_bytes=8 << 20, shared=True),
    "prefill": NTSpec("prefill", max_gbps=20.0, fixed_ns=5000.0),
    "decode": NTSpec("decode", max_gbps=10.0, fixed_ns=2000.0),
}


class ServeBackend:
    name = "serve"

    def __init__(self, model_cfg, engine_cfg=None, params=None, seed: int = 0,
                 name: str | None = None, capacity_gbps: float = 10.0,
                 device=None):
        # deferred import: keep `import repro_torch.api` light
        from repro_torch.serving.engine import Engine, EngineConfig
        if name is not None:
            self.name = name
        self.ecfg = engine_cfg or EngineConfig()
        self.engine = Engine(model_cfg, self.ecfg, params=params, seed=seed,
                             device=device)
        self.dags: dict[int, NTDag] = {}
        #: nominal wire capacity a placer/coordinator provisions against
        self.capacity_gbps = capacity_gbps
        #: fault-injection switchboard (armed by a fault injector, which the
        #: fleet layers bring; None = zero-cost hooks)
        self.faults = None

    # ----------------------------------------------------------- protocol --
    def capacity(self) -> dict:
        """Capacity probe / health heartbeat for a fleet coordinator:
        nominal Gbps plus live admission headroom.  Raises when crashed or
        hung; a degraded engine reports a reduced rate."""
        if self.faults is not None:
            self.faults.check_probe()
        scale = self.faults.degrade if self.faults is not None else 1.0
        cap = {"gbps": scale * self.capacity_gbps,
               "pending": self.engine.sched.pending()}
        if self.ecfg.max_pending is not None:
            cap["free_slots"] = max(
                0, self.ecfg.max_pending - self.engine.sched.pending())
        return cap

    def register(self, spec: NTSpec) -> None:
        if spec.name not in SERVE_SPECS:
            raise DagError(
                f"NT {spec.name!r} has no serving implementation; "
                f"available: {sorted(SERVE_SPECS)}")

    def add_tenant(self, tenant: str, weight: float) -> None:
        self.engine.add_tenant(tenant, weight)

    def remove_tenant(self, tenant: str) -> tuple[int, float]:
        return self.engine.remove_tenant(tenant)

    def deploy(self, dag: NTDag, **_kw) -> None:
        names = dag.all_nts()
        unknown = sorted(set(names) - set(SERVE_SPECS))
        if unknown:
            raise DagError(f"NT(s) {unknown} not servable; "
                           f"available: {sorted(SERVE_SPECS)}")
        if "prefill" not in names or "decode" not in names:
            raise DagError("a serving DAG needs the prefill and decode NTs")
        wants_cache = "cache" in names
        if self.dags and wants_cache != self.engine.ecfg.enable_cache_nt:
            state = ("enabled" if self.engine.ecfg.enable_cache_nt
                     else "disabled")
            raise DagError(
                "the response-cache NT is engine-wide and earlier "
                f"deployments {state} it; use a separate ServeBackend for a "
                "different cache setting")
        self.engine.ecfg.enable_cache_nt = wants_cache
        self.dags[dag.uid] = dag

    def prelaunch(self) -> None:
        """Paper §4.4 pre-launch: build the kernels and run the expected
        shapes ahead of traffic (the engine's PR analogue)."""
        self.engine.prelaunch()

    def inject(self, tenant: str, dag_uid: int, prompt, max_new: int = 16):
        if dag_uid not in self.dags:
            raise KeyError(f"DAG {dag_uid} not deployed")
        return self.engine.submit(tenant, prompt, max_new=max_new)

    def run(self, max_iters: int = 1000, **_kw) -> None:
        self.engine.run_until_drained(max_iters=max_iters)

    def report(self) -> PlatformReport:
        rep = PlatformReport(backend=self.name)
        for req in self.engine.done:
            tr = rep.tenants.setdefault(
                req.tenant, TenantReport(tenant=req.tenant, backend=self.name))
            tr.pkts_done += 1
            tr.outputs.append(req)
            tr.extra["cached"] = tr.extra.get("cached", 0) + int(req.cached)
        for tr in rep.tenants.values():
            tr.extra["weight"] = self.engine.weights.get(tr.tenant, 1.0)
            lats = [r.latency * 1e6 for r in tr.outputs]  # seconds -> us
            if lats:
                tr.mean_latency_us = sum(lats) / len(lats)
                tr.p99_latency_us = sorted(lats)[
                    min(len(lats) - 1, int(0.99 * len(lats)))]
        rep.extra["cache_hits"] = self.engine.cache_nt.hits
        rep.extra["cache_misses"] = self.engine.cache_nt.misses
        rep.extra["compile_log"] = list(self.engine.compile_log)
        return rep
