"""Distributed sNIC platform (§5): peer-to-peer control plane, NT migration,
pass-through forwarding, and cross-sNIC memory swapping.

Every sNIC periodically broadcasts (FPGA space, memory, port bandwidth) to
its rack peers; each keeps a local global view and decides independently.
When a local launch fails, the softcore picks the *closest* peer (ring
distance) with a free region, ships the bitstream (control msg: 2.3 us),
installs a MAT forwarding rule, and detours packets (+1.3 us/packet).  When
a local region frees up, the chain migrates back (launch local -> remove MAT
rule -> remove remote; stateful chains pause + move state first).
"""
from __future__ import annotations

from dataclasses import dataclass

from .nt import ChainProgram
from .regions import RegionState
from .sim import PAPER, EventSim
from .snic import SNIC, SNICConfig


@dataclass
class PeerView:
    free_regions: int = 0
    free_mem_frames: int = 0
    uplink_load: float = 0.0
    stamp_ns: float = 0.0


class Rack:
    """A rack of sNICs connected in a ring (plus the ToR uplink each)."""

    #: migrate-back polling gives up after this many attempts; the poll
    #: interval doubles each attempt (capped), so the budget covers
    #: MONITOR_NS * (2**MIGRATE_BACK_ATTEMPTS - 1) of wedged-peer time
    #: before the chain is left at the peer for good
    MIGRATE_BACK_ATTEMPTS = 12
    #: backoff cap: the interval stops doubling at MONITOR_NS << this
    MIGRATE_BACK_MAX_SHIFT = 6

    def __init__(self, sim: EventSim, snics: list[SNIC],
                 exchange_ns: float = PAPER.EPOCH_NS * 50):
        self.sim = sim
        self.snics = snics
        for s in snics:
            s.rack = self
        self.views: dict[str, dict[str, PeerView]] = {
            s.cfg.name: {} for s in snics}
        self.migrations: list[tuple[float, str, str, int]] = []
        #: migrate-back polls abandoned after the bounded retry budget —
        #: a wedged source can no longer park a migration poll forever
        self.migrate_back_giveups = 0
        self.exchange_ns = exchange_ns
        sim.after(exchange_ns, self._exchange)

    # ------------------------------------------------------- control plane --
    def _exchange(self) -> None:
        """Peer metadata broadcast (arrives after one control-msg latency)."""
        for s in self.snics:
            view = PeerView(
                free_regions=sum(1 for r in s.regions.regions
                                 if r.state == RegionState.FREE),
                free_mem_frames=len(s.vmem.free_frames),
                uplink_load=max(s.uplink_busy_until - self.sim.now, 0.0),
                stamp_ns=self.sim.now)
            for peer in self.snics:
                if peer is not s:
                    self.sim.after(PAPER.REMOTE_LAUNCH_NS,
                                   self._install_view, peer.cfg.name,
                                   s.cfg.name, view)
        self.sim.after(self.exchange_ns, self._exchange)

    def _install_view(self, at: str, about: str, view: PeerView) -> None:
        self.views[at][about] = view

    def _ring_distance(self, a: SNIC, b: SNIC) -> int:
        ia, ib = self.snics.index(a), self.snics.index(b)
        n = len(self.snics)
        return min((ia - ib) % n, (ib - ia) % n)

    # ---------------------------------------------------------- migration --
    def offload(self, src: SNIC, dag_uid: int, prog: ChainProgram,
                target: SNIC | None = None,
                migrate_back: bool = True) -> SNIC | None:
        """Launch ``prog`` at a peer and install a MAT forwarding rule at
        ``src``.  Without ``target`` the closest peer (ring distance) with a
        free region is picked — the paper's overload offload; with
        ``target`` the move is *directed* (a placer decided), and
        ``migrate_back=False`` keeps it there instead of polling to migrate
        home.  Returns the peer or None."""
        if target is None:
            cands = []
            for peer in self.snics:
                if peer is src:
                    continue
                view = self.views[src.cfg.name].get(peer.cfg.name)
                free = (view.free_regions if view is not None else
                        sum(1 for r in peer.regions.regions
                            if r.state == RegionState.FREE))
                if free > 0:
                    cands.append((self._ring_distance(src, peer), peer))
            if not cands:
                return None
            _, peer = min(cands, key=lambda x: x[0])
        else:
            if target is src:
                return None
            peer = target
        res = peer.regions.launch(prog, self.sim.now + PAPER.REMOTE_LAUNCH_NS,
                                  allow_context_switch=False)
        if res.region is None:
            return None
        if res.did_pr:
            self.sim.at(res.ready_ns, peer.regions.finish_pr, res.region)
        # the remote sNIC needs the DAG + program definitions to schedule
        for pg in src.programs:
            if pg not in peer.programs:
                peer.programs.append(pg)
        if prog not in peer.programs:
            peer.programs.append(prog)
        if dag_uid in src.dags:
            peer.dags[dag_uid] = src.dags[dag_uid]
            peer.stats.setdefault(src.dags[dag_uid].tenant, None) or \
                peer.stats.update({src.dags[dag_uid].tenant:
                                   src.stats[src.dags[dag_uid].tenant]})
        src.remote_dags[dag_uid] = peer
        self.migrations.append((self.sim.now, src.cfg.name,
                                peer.cfg.name, dag_uid))
        if migrate_back:
            # try to migrate back once a local region frees (poll)
            self.sim.after(PAPER.MONITOR_NS, self._try_migrate_back, src,
                           peer, dag_uid, prog)
        return peer

    def migrate_to(self, src: SNIC, dst: SNIC, dag_uid: int,
                   prog: ChainProgram | None = None) -> bool:
        """Directed deploy-on-new + drain-old migration of one DAG's chain
        (the placer-facing face of :meth:`offload`): launch at ``dst``,
        install the MAT detour at ``src``, and *stay* — no migrate-back
        polling.  ``prog`` defaults to the chain covering the DAG's first
        branch.  In-flight packets already past the parser finish on
        ``src``; everything arriving after the MAT rule lands detours."""
        if prog is None:
            dag = src.dags.get(dag_uid)
            if dag is None or not dag.stages:
                return False
            branch = dag.stages[0][0]
            prog = src._best_program(branch) or ChainProgram(tuple(branch))
        return self.offload(src, dag_uid, prog, target=dst,
                            migrate_back=False) is not None

    def _retry_migrate_back(self, src: SNIC, peer: SNIC, dag_uid: int,
                            prog: ChainProgram, attempt: int) -> None:
        """Re-poll with exponential backoff; bounded so a wedged source
        (regions never freeing) cannot park the poll forever — after the
        budget the chain simply stays at the peer and the give-up is
        counted for the report."""
        if attempt >= self.MIGRATE_BACK_ATTEMPTS:
            self.migrate_back_giveups += 1
            return
        delay = PAPER.MONITOR_NS * (
            1 << min(attempt, self.MIGRATE_BACK_MAX_SHIFT))
        self.sim.after(delay, self._try_migrate_back, src, peer, dag_uid,
                       prog, attempt + 1)

    def _try_migrate_back(self, src: SNIC, peer: SNIC, dag_uid: int,
                          prog: ChainProgram, attempt: int = 0) -> None:
        if dag_uid not in src.remote_dags:
            return
        has_free = any(r.state == RegionState.FREE
                       for r in src.regions.regions)
        if not has_free:
            self._retry_migrate_back(src, peer, dag_uid, prog, attempt)
            return
        res = src.regions.launch(prog, self.sim.now,
                                 allow_context_switch=False)
        if res.region is None:
            self._retry_migrate_back(src, peer, dag_uid, prog, attempt)
            return
        if res.did_pr:
            self.sim.at(res.ready_ns, src.regions.finish_pr, res.region)

        def finish():
            # remove MAT rule; free the remote region (stateless chains)
            src.remote_dags.pop(dag_uid, None)
            for r in peer.regions.active_regions():
                if r.program and r.program.names == prog.names:
                    peer.regions.deschedule(r, self.sim.now)
                    break
            self.migrations.append((self.sim.now, peer.cfg.name,
                                    src.cfg.name, dag_uid))
        self.sim.at(max(res.ready_ns, self.sim.now), finish)

    # ------------------------------------------------------ memory swapping --
    def remote_free_memory(self, src: SNIC) -> bool:
        """vmem hook: can any peer take one swapped page? (§4.5)"""
        return any(len(p.vmem.free_frames) > 0
                   for p in self.snics if p is not src)


def make_rack(sim: EventSim, n: int, specs, cfg_kw=None) -> Rack:
    cfgs = [SNICConfig(name=f"snic{i}", **(cfg_kw or {})) for i in range(n)]
    snics = [SNIC(sim, c, specs) for c in cfgs]
    rack = Rack(sim, snics)
    for s in snics:
        s.vmem.remote_free = lambda src=s: rack.remote_free_memory(src)
    return rack
