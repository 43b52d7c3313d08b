"""Region manager: NT (de-)launching under slow reconfiguration (§4.3-4.4, C4).

FPGA partial reconfiguration (PR) is the paper's unique constraint: ~5 ms per
region (800 MB/s PR throughput), orders slower than a software context
switch.  The policies reproduced here:

  - *pre-launch* NTs of a newly deployed app into free regions;
  - *on-demand* launch order: time-share an identical running NT ->
    free region -> victim region hosting the same program (instant revival,
    no PR) -> any pre-launched/victim region -> remote sNIC (hook) ->
    context-switch the least-loaded active region (stop-and-launch);
  - de-scheduled chains stay resident as *victims* (victim cache) until the
    region is actually needed;
  - the ML runtime swaps "PR" for a kernel build+load: same policy code, a
    different ``pr_ns`` model.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .nt import ChainProgram, NTInstance, NTSpec

PR_BYTES_PER_SEC = 800e6            # paper §4.3 (Coyote [46])
DEFAULT_PR_NS = 5e6                 # ~5 ms for the default region size


class RegionState(enum.Enum):
    FREE = "free"
    ACTIVE = "active"
    VICTIM = "victim"        # de-scheduled but bitstream still resident
    PR = "pr"                # reconfiguring


@dataclass
class Region:
    rid: int
    slots: int
    state: RegionState = RegionState.FREE
    program: ChainProgram | None = None
    instances: list[NTInstance] = field(default_factory=list)
    pr_done_ns: float = 0.0
    prelaunched: bool = False        # pre-launched, not yet used by traffic
    last_used_ns: float = 0.0

    def load(self) -> float:
        return sum(i.demand_bytes for i in self.instances)


@dataclass
class LaunchResult:
    region: Region | None            # None => must go remote / rejected
    ready_ns: float = 0.0            # absolute time the chain can serve
    did_pr: bool = False
    time_shared: bool = False
    victim_revived: bool = False
    context_switched: bool = False


class RegionManager:
    def __init__(self, n_regions: int, region_slots: int,
                 specs: dict[str, NTSpec], credits: int = 8,
                 pr_ns: float = DEFAULT_PR_NS):
        self.regions = [Region(i, region_slots) for i in range(n_regions)]
        self.region_slots = region_slots
        self.specs = specs
        self.credits = credits
        self.pr_ns = pr_ns
        self.pr_count = 0
        # name -> live instances (across regions), for time sharing/autoscale
        self.by_name: dict[str, list[NTInstance]] = {}

    # ------------------------------------------------------------ queries --
    def active_regions(self) -> list[Region]:
        return [r for r in self.regions if r.state == RegionState.ACTIVE]

    def covering_regions(self, branch: tuple[str, ...]) -> list[Region]:
        """All ACTIVE regions whose program covers ``branch`` (skip support)."""
        return [r for r in self.regions
                if r.state == RegionState.ACTIVE and r.program
                and r.program.covers(branch)]

    def find_program(self, branch: tuple[str, ...],
                     now_ns: float = 0.0) -> Region | None:
        """Least-loaded ACTIVE region covering ``branch`` — instance-level
        parallelism load-balances across scaled-out replicas (§4.2)."""
        cands = self.covering_regions(branch)
        if not cands:
            return None
        def backlog(r: Region) -> float:
            head = next(i for i in r.instances if i.name == branch[0])
            return max(head.busy_until_ns - now_ns, 0.0)
        return min(cands, key=lambda r: (backlog(r), len(r.program.names)))

    def capacity_gbps(self, name: str) -> float:
        return sum(i.spec.max_gbps for i in self.by_name.get(name, []))

    # ------------------------------------------------------------ mutators --
    def _install(self, region: Region, program: ChainProgram,
                 now_ns: float, *, pr: bool) -> LaunchResult:
        pr_t = self._pr_time(program) if pr else 0.0
        if pr:
            self.pr_count += 1
        self._uninstall(region)
        region.program = program
        region.state = RegionState.PR if pr else RegionState.ACTIVE
        region.pr_done_ns = now_ns + pr_t
        region.last_used_ns = now_ns
        region.instances = [
            NTInstance(self.specs[n], region.rid, slot=i, credits=self.credits)
            for i, n in enumerate(program.names)]
        for inst in region.instances:
            self.by_name.setdefault(inst.name, []).append(inst)
        return LaunchResult(region, now_ns + pr_t, did_pr=pr)

    def _uninstall(self, region: Region) -> None:
        for inst in region.instances:
            peers = self.by_name.get(inst.name, [])
            if inst in peers:
                peers.remove(inst)
        region.instances = []
        region.program = None

    def _pr_time(self, program: ChainProgram) -> float:
        if self.pr_ns is not None:
            return self.pr_ns
        return program.bitstream_bytes / PR_BYTES_PER_SEC * 1e9

    def finish_pr(self, region: Region) -> None:
        if region.state == RegionState.PR:
            region.state = RegionState.ACTIVE

    # ------------------------------------------------------------ policies --
    def pre_launch(self, program: ChainProgram, now_ns: float) -> LaunchResult | None:
        """Launch into a free region ahead of traffic; never evicts (§4.4)."""
        for r in self.regions:
            if r.state == RegionState.FREE:
                res = self._install(r, program, now_ns, pr=True)
                r.prelaunched = True
                return res
        return None

    def launch(self, program: ChainProgram, now_ns: float,
               allow_context_switch: bool = True) -> LaunchResult:
        """On-demand launch following the paper's policy ladder.

        Time-sharing an *identical live NT chain* is handled by the caller
        via ``find_program`` (it needs bandwidth headroom knowledge); this
        method starts at the 'free region' rung.
        """
        # 1) same program resident as a victim: instant revival, no PR
        for r in self.regions:
            if r.state == RegionState.VICTIM and r.program and \
                    r.program.names == program.names:
                r.state = RegionState.ACTIVE
                r.last_used_ns = now_ns
                return LaunchResult(r, now_ns, victim_revived=True)
        # 2) free region
        for r in self.regions:
            if r.state == RegionState.FREE:
                return self._install(r, program, now_ns, pr=True)
        # 3) victim or unused-prelaunched region (oldest first)
        cands = [r for r in self.regions
                 if r.state == RegionState.VICTIM
                 or (r.state == RegionState.ACTIVE and r.prelaunched)]
        if cands:
            r = min(cands, key=lambda r: r.last_used_ns)
            r.prelaunched = False
            return self._install(r, program, now_ns, pr=True)
        if not allow_context_switch:
            return LaunchResult(None)
        # 4) last resort: context-switch the least-loaded ACTIVE region
        act = self.active_regions()
        if not act:
            return LaunchResult(None)
        r = min(act, key=lambda r: r.load())
        res = self._install(r, program, now_ns, pr=True)
        res.context_switched = True
        return res

    def deschedule(self, region: Region, now_ns: float) -> None:
        """Stop a chain but keep it resident (victim cache)."""
        region.state = RegionState.VICTIM
        region.last_used_ns = now_ns

    def free(self, region: Region) -> None:
        self._uninstall(region)
        region.state = RegionState.FREE
        region.prelaunched = False
