"""The sNIC device model (§4): datapath only — parser, packet store, central
chain scheduler with credit reservation, NT regions, fork/join sync buffer.

Everything management-plane (per-tenant ingress queues + token-bucket rate
limits, epoch-driven DRF space sharing, instance autoscaling) lives in the
substrate-agnostic :class:`repro_torch.core.sched.FairScheduler`; this class
wires it to the event clock and applies its decisions with device mechanisms
(retry events, region PR launches).

Two scheduling modes reproduce the paper's comparison:
  - ``mode="snic"``  : NT-chain scheduling — credits for the *whole* chain are
    reserved up front; the packet traverses the chain without re-entering the
    scheduler (falls back to a mid-chain wait only when a later NT is out of
    credits) (§4.2).
  - ``mode="panic"`` : PANIC's optimistic scheme — push to the first NT on
    credit; each NT pushes onward regardless of the next NT's credit state;
    on a credit miss the packet bounces back to the central scheduler.

The same class drives both the paper-constant simulator benchmarks and the
ML-runtime serving engine (which subclasses the clock and the NT service
model).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis import invariants as _sanitize

from .nt import ChainProgram, NTDag, NTInstance, NTSpec, Packet, enumerate_programs
from .policy import UtilizationScaler
from .regions import LaunchResult, Region, RegionManager, RegionState
from .sched import FairScheduler, SchedConfig, SpaceShare
from .sim import GBPS, PAPER, EventSim, FlowStats
from .vmem import VirtualMemory


@dataclass
class SNICConfig:
    name: str = "snic0"
    n_regions: int = 8
    region_slots: int = 4
    uplink_gbps: float = PAPER.LINK_GBPS
    credits: int = PAPER.CREDITS
    pkt_store_bytes: int = 8 << 20
    mem_bytes: int = 10 << 30              # HTG-9200: 10 GB on-board
    mode: str = "snic"                     # snic | panic
    # timing (paper constants by default)
    core_ns: float = PAPER.SNIC_CORE_NS
    phy_ns: float = (PAPER.FULL_PATH_NS - PAPER.SNIC_CORE_NS) / 2
    sched_ns: float = PAPER.SCHED_NS
    sync_ns: float = PAPER.SYNC_NS
    pr_ns: float = PAPER.PR_NS
    epoch_ns: float = PAPER.EPOCH_NS
    drf_ns: float = PAPER.DRF_NS
    monitor_ns: float = PAPER.MONITOR_NS
    # policy knobs
    enable_drf: bool = True
    enable_autoscale: bool = True
    autoscale_hi: float = 0.95             # scale out above this utilization
    autoscale_lo: float = 0.25             # scale down below this
    # rate-limit slack over the DRF grant: the limiter enforces FAIRNESS,
    # not admission (the uplink is the physical limit); at 1.25x the token-
    # bucket quantization under bursty small packets wastes ~70% of a
    # saturated uplink (measured; see EXPERIMENTS fig12 note)
    ingress_headroom: float = 2.0
    ingress_floor_gbps: float = 0.5        # minimum tenant rate (ramp-up)
    tenant_weights: dict = field(default_factory=dict)


class _Fork:
    """Join state for one packet's parallel stage (sync buffer, §4.2)."""
    __slots__ = ("remaining", "next_stage")

    def __init__(self, remaining: int, next_stage: int):
        self.remaining = remaining
        self.next_stage = next_stage


class SNIC:
    def __init__(self, sim: EventSim, cfg: SNICConfig,
                 specs: dict[str, NTSpec], rack=None):
        self.sim = sim
        self.cfg = cfg
        self.specs = specs
        self.rack = rack                    # distributed platform hook (§5)
        self.regions = RegionManager(cfg.n_regions, cfg.region_slots, specs,
                                     credits=cfg.credits, pr_ns=cfg.pr_ns)
        self.vmem = VirtualMemory(cfg.mem_bytes)
        self.dags: dict[int, NTDag] = {}
        self.programs: list[ChainProgram] = []
        self.remote_dags: dict[int, object] = {}   # dag_uid -> peer SNIC
        self.stats: dict[str, FlowStats] = {}
        self.pid = 0
        # management plane: the shared fair scheduler (per-tenant paced
        # ingress queues + epoch DRF + autoscale policy), on the sim clock.
        # strict=False keeps the sNIC's open-world tenancy: traffic sources
        # inject for tenants that never registered (weight defaults to 1).
        self.sched = FairScheduler(
            cfg.tenant_weights,
            SchedConfig(quantum=1500.0, max_backlog=4 << 20,
                        bucket_window=2 * cfg.epoch_ns,   # 2-epoch bucket
                        min_retry=16.0,                   # >= 1 cycle
                        max_retry=cfg.epoch_ns, strict=False),
            clock=lambda: self.sim.now,
            scale=UtilizationScaler(cfg.autoscale_hi, cfg.autoscale_lo,
                                    dwell_ns=cfg.monitor_ns))
        # uplink/egress server
        self.uplink_busy_until = 0.0
        self.egress_bytes = 0.0
        self.store_bytes = 0.0
        # per-NT waiters: instance -> list of (packet, region, slot, stage)
        self.waiters: dict[int, list] = {}
        self.forks: dict[int, _Fork] = {}
        # throughput timeline samples [(t, tenant, nt, bytes)]
        self.tput_log: list = []
        self.log_tput = False
        self.done_hook = None
        if cfg.enable_drf:
            sim.after(cfg.epoch_ns, self._epoch)
        if cfg.enable_autoscale:
            sim.after(cfg.monitor_ns, self._monitor)

    # ============================================================= deploy ====
    def deploy(self, dags: list[NTDag],
               programs: list[ChainProgram] | None = None,
               prelaunch: bool = True) -> None:
        """User NT/DAG deployment (§3): generate bitstreams, pre-launch."""
        for d in dags:
            self.dags[d.uid] = d
            self.stats.setdefault(d.tenant, FlowStats())
            for n in d.all_nts():
                self.vmem.register(n)
        if programs is None:
            programs = enumerate_programs(list(self.dags.values()), self.specs,
                                          self.cfg.region_slots)
        self.programs = programs
        if prelaunch:
            # longest-chain-first: whole branches before fragments (§4.4)
            want: list[tuple[str, ...]] = []
            for d in dags:
                for stage in d.stages:
                    want.extend(stage)
            todo = []
            for branch in sorted(set(want), key=len, reverse=True):
                prog = self._best_program(branch)
                if prog and prog not in todo:
                    todo.append(prog)
                    # a split chain needs its tail program(s) resident too
                    rest = branch[len(prog.names):]
                    while rest:
                        tail = self._best_program(rest)
                        if tail is None:
                            break
                        if tail not in todo:
                            todo.append(tail)
                        rest = rest[len(tail.names):]
            for prog in todo:
                if any(r.program and r.program.names == prog.names
                       for r in self.regions.regions):
                    continue
                res = self.regions.pre_launch(prog, self.sim.now)
                if res:
                    self.sim.at(res.ready_ns, self.regions.finish_pr,
                                res.region)

    def _best_program(self, branch: tuple[str, ...]) -> ChainProgram | None:
        covering = [p for p in self.programs if p.covers(branch)]
        if covering:
            return min(covering, key=lambda p: len(p.names))
        # fall back to the longest placeable prefix
        best = None
        for p in self.programs:
            if branch[:len(p.names)] == p.names:
                if best is None or len(p.names) > len(best.names):
                    best = p
        return best

    # ============================================================ ingress ====
    def inject(self, tenant: str, dag_uid: int, size_bytes: int) -> None:
        """Entry point for traffic sources (endpoint -> sNIC RX)."""
        self.pid += 1
        pkt = Packet(self.pid, tenant, dag_uid, size_bytes,
                     arrival_ns=self.sim.now)
        # offered-load monitoring happens BEFORE the rate limiter: "even if
        # there is no credit, we still capture the intended load" (§4.4)
        self.sched.observe(tenant, "ingress", size_bytes)
        st = self.stats.setdefault(tenant, FlowStats())
        if not self.sched.submit(tenant, pkt, size_bytes):
            st.drops += 1                 # backlog cap: counted, not silent
            return
        if self.sched.queued(tenant) == 1:
            self._pump(tenant)

    def _pump(self, tenant: str) -> None:
        """Serve the tenant's paced queue: parse on credit, retry on none."""
        pkt, delay = self.sched.poll(tenant)
        if pkt is None:
            if delay is not None:         # head waiting for token credits
                self.sim.after(delay, self._pump, tenant)
            return
        self._parse(pkt)
        if self.sched.queued(tenant):
            self.sim.after(0.0, self._pump, tenant)

    def _parse(self, pkt: Packet) -> None:
        """Parser + MAT routing (§4.1) after the ingress PHY/MAC."""
        pkt.ingress_ns = self.sim.now
        if pkt.dag_uid in self.remote_dags:          # MAT: forward to peer
            peer = self.remote_dags[pkt.dag_uid]
            pkt.hops += 1
            self.sim.after(self.cfg.phy_ns + PAPER.REMOTE_HOP_NS,
                           peer._parse, pkt)
            return
        dag = self.dags.get(pkt.dag_uid)
        if dag is None or not dag.stages:             # simple switching
            self.sim.after(self.cfg.phy_ns + self.cfg.core_ns,
                           self._egress, pkt)
            return
        self.store_bytes += pkt.size_bytes            # payload -> packet store
        self.sched.observe(pkt.tenant, "store", pkt.size_bytes)
        self.sim.after(self.cfg.phy_ns + self.cfg.core_ns,
                       self._start_stage, pkt, 0)

    # ========================================================== scheduler ====
    def _start_stage(self, pkt: Packet, stage_idx: int) -> None:
        dag = self.dags[pkt.dag_uid]
        if stage_idx >= len(dag.stages):
            self.store_bytes -= pkt.size_bytes
            self._egress(pkt)
            return
        stage = dag.stages[stage_idx]
        if len(stage) > 1:                            # NT-level parallelism
            self.forks[pkt.pid] = _Fork(len(stage), stage_idx + 1)
        for branch in stage:
            self._sched_branch(pkt, branch, stage_idx)

    def _sched_branch(self, pkt: Packet, branch: tuple[str, ...],
                      stage_idx: int) -> None:
        """One scheduler pass for one branch (64 ns fixed delay)."""
        pkt.sched_visits += 1
        region = self.regions.find_program(branch, self.sim.now)
        rest: tuple[str, ...] = ()
        if region is None:
            # sub-chain split (§4.3): longest prefix hosted by one region
            # runs now; the remainder takes another scheduler pass.
            for j in range(len(branch) - 1, 0, -1):
                region = self.regions.find_program(branch[:j], self.sim.now)
                if region is not None:
                    rest = branch[j:]
                    branch = branch[:j]
                    break
        if region is None:
            self._launch_for(pkt, branch, stage_idx)
            return
        # demand monitoring: intended load, measured pre-credit (§4.4)
        for name in branch:
            inst = self._inst_in(region, name)
            inst.demand_bytes += pkt.size_bytes
            self.sched.observe(pkt.tenant, f"nt:{name}", pkt.size_bytes)
        region.prelaunched = False
        region.last_used_ns = self.sim.now
        if self.cfg.mode == "panic":
            self._panic_dispatch(pkt, region, branch, 0, stage_idx, rest)
        else:
            self._chain_dispatch(pkt, region, branch, stage_idx, rest)

    def _inst_in(self, region: Region, name: str) -> NTInstance:
        for i in region.instances:
            if i.name == name:
                return i
        raise KeyError(name)

    def _chain_dispatch(self, pkt: Packet, region: Region,
                        branch: tuple[str, ...], stage_idx: int,
                        rest: tuple[str, ...] = ()) -> None:
        """sNIC mode: reserve credits front-to-first-miss, then dispatch."""
        granted = 0
        for name in branch:
            inst = self._inst_in(region, name)
            if inst.credits > 0:
                inst.credits -= 1
                granted += 1
            else:
                break
        self.sim.after(self.cfg.sched_ns, self._run_chain, pkt, region,
                       branch, 0, granted, stage_idx, rest)

    def _run_chain(self, pkt: Packet, region: Region, branch: tuple[str, ...],
                   k: int, granted: int, stage_idx: int,
                   rest: tuple[str, ...] = ()) -> None:
        """Execute NT k of the branch inside ``region``."""
        if k >= len(branch):
            if rest:                       # sub-chain continuation (§4.3)
                self._sched_branch(pkt, rest, stage_idx)
            else:
                self._branch_done(pkt, stage_idx)
            return
        inst = self._inst_in(region, branch[k])
        if k >= granted:
            # ran out of reserved credits mid-chain: wait at this NT (§4.2)
            if inst.credits > 0:
                inst.credits -= 1
            else:
                self.waiters.setdefault(id(inst), []).append(
                    (pkt, region, branch, k, granted, stage_idx, rest))
                return
        start = max(self.sim.now, inst.busy_until_ns)
        service = pkt.size_bytes * inst.spec.ns_per_byte
        inst.busy_until_ns = start + service
        done = start + service + inst.spec.fixed_ns
        self.sim.at(done, self._nt_done, pkt, region, branch, k,
                    granted, stage_idx, inst, rest)

    def _nt_done(self, pkt: Packet, region: Region, branch: tuple[str, ...],
                 k: int, granted: int, stage_idx: int,
                 inst: NTInstance, rest: tuple[str, ...] = ()) -> None:
        inst.served_bytes += pkt.size_bytes
        inst.served_pkts += 1
        if self.log_tput:
            self.tput_log.append((self.sim.now, pkt.tenant, inst.name,
                                  pkt.size_bytes))
        self._release_credit(inst)
        self._run_chain(pkt, region, branch, k + 1, granted, stage_idx, rest)

    def _release_credit(self, inst: NTInstance) -> None:
        w = self.waiters.get(id(inst))
        if w:
            pkt, region, branch, k, granted, stage_idx, rest = w.pop(0)
            # hand the credit straight to the waiter
            self.sim.after(self.cfg.sched_ns, self._run_chain, pkt, region,
                           branch, k, k + 1, stage_idx, rest)
        else:
            inst.credits += 1

    # ---------------------------------------------------------- PANIC mode --
    def _panic_dispatch(self, pkt: Packet, region: Region,
                        branch: tuple[str, ...], k: int,
                        stage_idx: int, rest: tuple[str, ...] = ()) -> None:
        inst = self._inst_in(region, branch[k])
        if inst.credits > 0:
            inst.credits -= 1
            self.sim.after(self.cfg.sched_ns, self._panic_run, pkt, region,
                           branch, k, stage_idx, rest)
        else:
            self.waiters.setdefault(id(inst), []).append(
                ("panic", pkt, region, branch, k, stage_idx, rest))

    def _panic_run(self, pkt: Packet, region: Region, branch: tuple[str, ...],
                   k: int, stage_idx: int, rest: tuple[str, ...] = ()) -> None:
        inst = self._inst_in(region, branch[k])
        start = max(self.sim.now, inst.busy_until_ns)
        service = pkt.size_bytes * inst.spec.ns_per_byte
        inst.busy_until_ns = start + service
        self.sim.at(start + service + inst.spec.fixed_ns, self._panic_done,
                    pkt, region, branch, k, stage_idx, inst, rest)

    def _panic_done(self, pkt: Packet, region: Region,
                    branch: tuple[str, ...], k: int, stage_idx: int,
                    inst: NTInstance, rest: tuple[str, ...] = ()) -> None:
        inst.served_bytes += pkt.size_bytes
        inst.served_pkts += 1
        if self.log_tput:
            self.tput_log.append((self.sim.now, pkt.tenant, inst.name,
                                  pkt.size_bytes))
        # release this NT's credit
        w = self.waiters.get(id(inst))
        if w:
            _, wp, wr, wb, wk, ws, wrest = w.pop(0)
            self.sim.after(self.cfg.sched_ns, self._panic_run, wp, wr, wb,
                           wk, ws, wrest)
        else:
            inst.credits += 1
        if k + 1 >= len(branch):
            if rest:
                self._sched_branch(pkt, rest, stage_idx)
            else:
                self._branch_done(pkt, stage_idx)
            return
        # PANIC: NTs are not co-located in a chain region; every hop goes
        # through the crossbar + central scheduler, and a credit miss at the
        # next NT bounces the packet back to the scheduler's wait queue.
        pkt.sched_visits += 1
        self.sim.after(self.cfg.sched_ns, self._panic_dispatch, pkt,
                       region, branch, k + 1, stage_idx, rest)

    # ---------------------------------------------------------- fork/join --
    def _branch_done(self, pkt: Packet, stage_idx: int) -> None:
        fork = self.forks.get(pkt.pid)
        if fork is not None:
            fork.remaining -= 1
            if fork.remaining > 0:
                return
            del self.forks[pkt.pid]
            self.sim.after(self.cfg.sync_ns, self._start_stage, pkt,
                           fork.next_stage)
            return
        self._start_stage(pkt, stage_idx + 1)

    # ----------------------------------------------------------- launching --
    def _launch_for(self, pkt: Packet, branch: tuple[str, ...],
                    stage_idx: int) -> None:
        """On-demand NT launch ladder (§4.4); packet is buffered until ready."""
        # a racing packet may have offloaded this DAG already: follow the
        # MAT rule instead of double-launching (and, worst case, context-
        # switching a live region)
        if pkt.dag_uid in self.remote_dags:
            peer = self.remote_dags[pkt.dag_uid]
            pkt.hops += 1
            self.sim.after(self.cfg.phy_ns + PAPER.REMOTE_HOP_NS,
                           peer._parse, pkt)
            return
        # a covering region may already be reconfiguring: wait for it
        for r in self.regions.regions:
            if r.state == RegionState.PR and r.program and \
                    r.program.covers(branch):
                self.sim.at(max(r.pr_done_ns, self.sim.now) + 1.0,
                            self._sched_branch, pkt, branch, stage_idx)
                return
        prog = self._best_program(branch)
        if prog is None:
            prog = ChainProgram(tuple(branch))
        # try local (free/victim/prelaunched), then remote, then ctx switch
        res = self.regions.launch(prog, self.sim.now,
                                  allow_context_switch=False)
        if res.region is None and self.rack is not None:
            peer = self.rack.offload(self, pkt.dag_uid, prog)
            if peer is not None:
                self.sim.after(0.0, self._parse, pkt)      # re-route via MAT
                return
        if res.region is None:
            res = self.regions.launch(prog, self.sim.now,
                                      allow_context_switch=True)
        if res.region is None:
            self.stats[pkt.tenant].drops += 1
            return
        if res.did_pr:
            self.sim.at(res.ready_ns, self.regions.finish_pr, res.region)
        res.region.prelaunched = False
        self.sim.at(max(res.ready_ns, self.sim.now), self._sched_branch, pkt,
                    branch, stage_idx)

    # -------------------------------------------------------------- egress --
    def _egress(self, pkt: Packet) -> None:
        rate = self.cfg.uplink_gbps * GBPS
        start = max(self.sim.now, self.uplink_busy_until)
        self.uplink_busy_until = start + pkt.size_bytes / rate
        self.sched.observe(pkt.tenant, "egress", pkt.size_bytes)
        self.sim.at(self.uplink_busy_until + self.cfg.phy_ns,
                    self._done, pkt)

    def _done(self, pkt: Packet) -> None:
        pkt.done_ns = self.sim.now
        st = self.stats.setdefault(pkt.tenant, FlowStats())
        st.latencies_ns.append(pkt.latency_ns)
        st.bytes_done += pkt.size_bytes
        st.pkts_done += 1
        if self.done_hook:
            self.done_hook(pkt)

    # ======================================================== control loop ====
    def _capacities(self) -> dict[str, float]:
        """Per-epoch capacity vector: link, store, and every live NT."""
        caps = {"ingress": self.cfg.uplink_gbps * GBPS * self.cfg.epoch_ns,
                "egress": self.cfg.uplink_gbps * GBPS * self.cfg.epoch_ns,
                "store": float(self.cfg.pkt_store_bytes)}
        for name, insts in self.regions.by_name.items():
            caps[f"nt:{name}"] = sum(
                i.spec.max_gbps for i in insts) * GBPS * self.cfg.epoch_ns
        return caps

    def _epoch(self) -> None:
        """Per-epoch DRF (§4.4): measured demands -> ingress rate limits.
        The scheduler solves; the device applies the grants after the
        solver's 3 us runtime and re-pumps the paced queues."""
        if not self.cfg.enable_drf:
            return          # loop handed off (e.g. to a cross-shard epoch)
        if _sanitize.enabled():       # opt-in epoch-boundary sanitizer
            _sanitize.check_snic(self, f"snic@{self.sim.now:.0f}ns")
        res = self.sched.epoch(
            self._capacities(),
            # standing backlog counts as ingress demand on top of the
            # arrival monitors
            extra=self.sched.backlog_demand("ingress"))
        if res is not None:
            rates = SpaceShare.to_rates(
                res, "ingress", self.cfg.epoch_ns,
                headroom=self.cfg.ingress_headroom,
                floor=self.cfg.ingress_floor_gbps * GBPS)
            apply_at = self.sim.now + self.cfg.drf_ns       # 3 us solver
            for t, rate in rates.items():
                self.sim.at(apply_at, self._apply_rate, t, rate)
        for insts in self.regions.by_name.values():
            for i in insts:
                i.demand_bytes = 0.0
        self.sim.after(self.cfg.epoch_ns, self._epoch)

    def _apply_rate(self, tenant: str, rate: float) -> None:
        self.sched.set_rate(tenant, rate)
        self._pump(tenant)

    # --------------------------------------------------------- autoscaling --
    def _monitor(self) -> None:
        """Instance autoscaling with MONITOR_PERIOD hysteresis (§4.4)."""
        if not self.cfg.enable_autoscale:
            return
        window = self.cfg.monitor_ns
        for name, insts in list(self.regions.by_name.items()):
            live = [i for i in insts
                    if self.regions.regions[i.region_id].state
                    == RegionState.ACTIVE]
            if not live:
                continue
            cap = sum(i.spec.max_gbps for i in live) * GBPS * window
            served = sum(i.served_bytes for i in live)  # within the window
            direction = self.sched.autoscale(name, served, cap,
                                             n_instances=len(live))
            if direction > 0:
                self._scale_out(name)
            elif direction < 0:
                self._scale_down(name)
            for i in insts:
                i.served_bytes = 0.0
                i.served_pkts = 0
        self.sim.after(self.cfg.monitor_ns, self._monitor)

    def _scale_out(self, name: str) -> None:
        prog = ChainProgram((name,),
                            self.specs[name].bitstream_bytes)
        res = self.regions.launch(prog, self.sim.now,
                                  allow_context_switch=False)
        if res.region is not None and res.did_pr:
            self.sim.at(res.ready_ns, self.regions.finish_pr, res.region)

    def _scale_down(self, name: str) -> None:
        # victim-cache a single-NT region serving this name
        for r in self.regions.active_regions():
            if r.program and r.program.names == (name,):
                self.regions.deschedule(r, self.sim.now)
                return

    # ------------------------------------------------------------- reports --
    def capacity_probe(self) -> dict:
        """Live capacity snapshot for a placer / cross-shard coordinator:
        link headroom in grant units (bytes per epoch), free FPGA regions,
        free memory frames, and packet-store headroom."""
        return {
            "uplink_gbps": self.cfg.uplink_gbps,
            "ingress_bytes_per_epoch":
                self.cfg.uplink_gbps * GBPS * self.cfg.epoch_ns,
            "epoch_ns": self.cfg.epoch_ns,
            "free_regions": sum(1 for r in self.regions.regions
                                if r.state == RegionState.FREE),
            "free_mem_frames": len(self.vmem.free_frames),
            "store_bytes_free": max(
                self.cfg.pkt_store_bytes - self.store_bytes, 0.0),
        }

    def total_gbps(self, dur_ns: float) -> float:
        return sum(s.bytes_done for s in self.stats.values()) / dur_ns / GBPS
