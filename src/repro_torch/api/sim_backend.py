"""SimBackend: the Platform face of the paper-constant sNIC device model.

Wraps :class:`EventSim` + :class:`SNIC` (and optionally a multi-sNIC
:class:`Rack`) behind the backend protocol.  Traffic comes from explicit
``inject`` calls or from the attached stochastic sources
(:func:`poisson_source` & friends); ``run`` advances virtual time and the
report carries the per-tenant latency/Gbps/drop statistics the paper's
figures are built from.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis import invariants as _sanitize
from repro_torch.core.distributed import Rack
from repro_torch.core.nt import NTDag, NTSpec
from repro_torch.core.sim import (EventSim, FlowStats, fb_kv_source,
                                  onoff_source, poisson_source)
from repro_torch.core.snic import SNIC, SNICConfig
from repro_torch.core.sim import GBPS, MS, US  # noqa: F401  (re-export)

from .backend import PlatformReport, TenantReport

_SOURCES = {"poisson": poisson_source, "fb_kv": fb_kv_source,
            "onoff": onoff_source}


class SimBackend:
    name = "sim"

    def __init__(self, config: SNICConfig | None = None, n_snics: int = 1,
                 specs: dict[str, NTSpec] | None = None,
                 name: str | None = None, seed: int = 0):
        """``name`` and ``seed`` give each instance an explicit shard
        identity: the sNIC device names derive from ``name``, and sources
        attached without an explicit ``seed`` draw decorrelated streams
        from this backend's seed — so a fleet of SimBackends never shares
        implicit global state."""
        if name is not None:
            self.name = name
        self.seed = seed
        self._n_sources = 0
        self.sim = EventSim()
        self.specs: dict[str, NTSpec] = dict(specs or {})
        cfg = config or SNICConfig(name=f"{self.name}.snic0")
        if n_snics > 1:
            cfgs = [dataclasses.replace(
                        cfg, name=f"{self.name}.snic{i}",
                        tenant_weights=dict(cfg.tenant_weights))
                    for i in range(n_snics)]
            self.snics = [SNIC(self.sim, c, self.specs) for c in cfgs]
            self.rack: Rack | None = Rack(self.sim, self.snics)
            for s in self.snics:
                s.vmem.remote_free = (
                    lambda src=s: self.rack.remote_free_memory(src))
        else:
            self.snics = [SNIC(self.sim, cfg, self.specs)]
            self.rack = None
        self.snic = self.snics[0]
        self._t0: float | None = None
        self._elapsed_ns = 0.0
        #: fault-injection switchboard (armed by a FaultInjector; None =
        #: zero-cost hooks)
        self.faults = None

    # ----------------------------------------------------------- protocol --
    @property
    def region_slots(self) -> int:
        return self.snic.cfg.region_slots

    # ------------------------------------------------------ sharding hooks --
    @property
    def sched(self):
        """The shard's FairScheduler, for the cross-shard epoch — None for
        a multi-sNIC backend: its per-sNIC schedulers/capacities are not
        one coherent shard vector (the internal Rack balances them), so the
        fleet coordinator leaves such a shard locally managed."""
        return self.snic.sched if len(self.snics) == 1 else None

    @property
    def epoch_ns(self) -> float:
        return self.snic.cfg.epoch_ns

    def capacity(self) -> dict:
        """Capacity probe for a placer: nominal Gbps plus live device
        headroom (regions/memory/store) from the sNIC probes.  Doubles as
        the health heartbeat — a crashed or hung shard raises here (a
        probe miss), and a degraded shard reports its reduced rate."""
        if self.faults is not None:
            self.faults.check_probe()
        probes = [s.capacity_probe() for s in self.snics]
        scale = self.faults.degrade if self.faults is not None else 1.0
        return {
            "gbps": scale * sum(p["uplink_gbps"] for p in probes),
            "bytes_per_epoch": scale * sum(p["ingress_bytes_per_epoch"]
                                           for p in probes),
            "free_regions": sum(p["free_regions"] for p in probes),
            "free_mem_frames": sum(p["free_mem_frames"] for p in probes),
        }

    def defer_epochs(self) -> None:
        """Hand the DRF epoch loop to an external (cross-shard)
        coordinator: the per-sNIC epoch stops firing, and the coordinator
        applies grants via :meth:`apply_grants`.  No-op for a multi-sNIC
        backend (see :attr:`sched`) — its internal epochs stay live."""
        if len(self.snics) > 1:
            return
        for s in self.snics:
            s.cfg.enable_drf = False

    def apply_grants(self, grants: dict[str, float],
                     window_ns: float) -> None:
        """Convert per-window byte grants into ingress token rates with the
        same headroom/floor policy the local epoch uses, then re-pump.
        This is the deferred shard's epoch boundary, so the per-instance
        demand monitors reset here exactly as the local epoch would."""
        for s in self.snics:
            cfg = s.cfg
            for t, g in grants.items():
                if t not in s.sched.queues:
                    continue
                rate = max(g * cfg.ingress_headroom / max(window_ns, 1.0),
                           cfg.ingress_floor_gbps * GBPS)
                s.sched.set_rate(t, rate)
                s._pump(t)
            for insts in s.regions.by_name.values():
                for i in insts:
                    i.demand_bytes = 0.0

    def register(self, spec: NTSpec) -> None:
        self.specs[spec.name] = spec

    def add_tenant(self, tenant: str, weight: float) -> None:
        for s in self.snics:
            s.cfg.tenant_weights[tenant] = weight
            s.sched.add_tenant(tenant, weight)
            s.stats.setdefault(tenant, FlowStats())

    def remove_tenant(self, tenant: str) -> tuple[int, float]:
        """Tenant churn: unregister from every sNIC scheduler (queued work
        is shed and counted as drops).  Completed-work stats are kept so
        the final report still covers the departed tenant's service."""
        items, cost = 0, 0.0
        for s in self.snics:
            s.cfg.tenant_weights.pop(tenant, None)
            n, c = s.sched.remove_tenant(tenant)
            items += n
            cost += c
        return items, cost

    def shed_backlog(self, tenant: str, cost_limit: float) -> tuple[int, float]:
        """Backpressure: cap the tenant's queued ingress bytes on every
        sNIC scheduler.  Shed packets are charged to the tenant's FlowStats
        drops so the report (and the I-PKTS sum) accounts for them."""
        items, cost = 0, 0.0
        for s in self.snics:
            n, c = s.sched.shed_backlog(tenant, cost_limit)
            if n and tenant in s.stats:
                s.stats[tenant].drops += n
            items += n
            cost += c
        return items, cost

    def deploy(self, dag: NTDag, prelaunch: bool = True, snic: int = 0,
               programs=None, **_kw) -> None:
        """``programs`` overrides bitstream enumeration (§4.3) — e.g. to
        force a split-chain placement for benchmarking."""
        self.snics[snic].deploy([dag], programs=programs,
                                prelaunch=prelaunch)

    def inject(self, tenant: str, dag_uid: int, size_bytes: int,
               snic: int = 0) -> None:
        if self.faults is not None:
            dag = self.snics[snic].dags.get(dag_uid)
            verdict = self.faults.gate_inject(
                tenant, dag.all_nts() if dag is not None else ())
            if verdict == "drop":
                return          # pre-NIC wire loss: counted on the FaultState
        self.snics[snic].inject(tenant, dag_uid, size_bytes)

    def add_source(self, kind: str, tenant: str, dag_uid: int,
                   duration_ms: float | None = None, snic: int = 0,
                   sink=None, **kw) -> None:
        """Attach a stochastic traffic source starting at current sim time.
        ``sink`` overrides where emissions land (default: this backend's
        sNIC) — a sharded coordinator passes its own routed inject so a
        migrated deployment's traffic follows the routing table."""
        try:
            src = _SOURCES[kind]
        except KeyError:
            raise ValueError(
                f"unknown source {kind!r}; known: {sorted(_SOURCES)}")
        until = (self.sim.now + duration_ms * MS if duration_ms is not None
                 else math.inf)
        if "seed" not in kw:
            # explicit per-backend seed identity: two shards built with
            # different seeds draw decorrelated traffic by default
            kw["seed"] = self.seed + 1000003 * self._n_sources
        self._n_sources += 1
        src(self.sim, tenant=tenant, dag_uid=dag_uid,
            sink=sink if sink is not None else self.snics[snic].inject,
            until_ns=until, **kw)

    def settle(self) -> None:
        """Let in-flight partial reconfigurations finish (pre-launch PR) so a
        measurement window starts with the deployed chains live.  Resets the
        Gbps measurement window: it restarts at the next ``run``."""
        self.sim.run(self.sim.now + self.snic.cfg.pr_ns + 1)
        self._t0 = None
        self._elapsed_ns = 0.0
        if _sanitize.enabled():
            _sanitize.check_fleet(self.snics, f"{self.name}/settle")

    def run(self, duration_ms: float | None = None,
            duration_ns: float | None = None, settle: bool = False,
            **_kw) -> None:
        """Advance virtual time.  The measurement window (for Gbps) spans
        every ``run`` call since backend creation or the last ``settle``
        (``settle`` resets the window so PR wait time is not counted)."""
        if settle:
            self.settle()
        if self.faults is not None and not self.faults.serving():
            return          # crashed/hung: the virtual clock freezes
        if duration_ns is None:
            duration_ns = (duration_ms if duration_ms is not None else 1.0) \
                * MS
        if self._t0 is None:
            self._t0 = self.sim.now
        self.sim.run(self.sim.now + duration_ns)
        self._elapsed_ns = self.sim.now - self._t0
        if _sanitize.enabled():      # end-of-window conservation audit
            _sanitize.check_fleet(self.snics, f"{self.name}/run")

    def report(self) -> PlatformReport:
        dur = max(self._elapsed_ns, 1.0)
        rep = PlatformReport(backend=self.name, duration_ns=dur)
        merged: dict[str, FlowStats] = {}
        seen: set[int] = set()
        for s in self.snics:
            for tenant, st in s.stats.items():
                if id(st) in seen:      # rack: peers may share a FlowStats
                    continue
                seen.add(id(st))
                dst = merged.setdefault(tenant, FlowStats())
                dst.latencies_ns.extend(st.latencies_ns)
                dst.bytes_done += st.bytes_done
                dst.pkts_done += st.pkts_done
                dst.drops += st.drops
        for tenant, st in merged.items():
            rep.tenants[tenant] = TenantReport(
                tenant=tenant, backend=self.name,
                pkts_done=st.pkts_done, bytes_done=st.bytes_done,
                drops=st.drops,
                mean_latency_us=st.mean_latency_us(),
                p99_latency_us=st.p99_us(),
                gbps=st.gbps(dur))
            rep.tenants[tenant].extra["weight"] = \
                self.snic.sched.weights.get(tenant, 1.0)
        rep.extra["pr_count"] = sum(s.regions.pr_count for s in self.snics)
        if self.rack is not None:
            rep.extra["migrate_back_giveups"] = self.rack.migrate_back_giveups
        if self.faults is not None:
            rep.extra["faults"] = self.faults.summary()
        return rep
