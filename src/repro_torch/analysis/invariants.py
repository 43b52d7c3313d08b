"""Runtime invariant harness (the sanitizer pass).

Opt-in dynamic checks of the conservation laws the scheduling/accounting
core promises, evaluated at epoch boundaries when ``REPRO_SANITIZE=1`` is
set in the environment.  In the port the hooks are wired into
:meth:`repro_torch.api.compute_backend.ComputeBackend.run` and
``inject_stream`` (end of drain),
:meth:`repro_torch.api.sharded_backend.ShardedBackend._global_epoch` and
:meth:`repro_torch.serving.engine.Engine.step`; the sNIC model and the sim
backend carry the other hooks in the JAX package and are not ported yet,
so their rules below are kept for when they are.

Rules (each violation is a :class:`~repro_torch.analysis.diagnostics.Diagnostic`
wrapped in :class:`InvariantViolation`):

  - **I-CREDIT**: per tenant queue, cost granted == cost served + standing
    backlog.  ``push`` adds to ``granted_cost``; a requeue's ``push_front``
    does not (its paired ``pop`` is reversed by the scheduler), so the law
    survives admit/requeue cycles.
  - **I-DEFICIT**: the WDRR deficit counter never goes below ``-COST_EPS``
    — :class:`~repro_torch.core.sched.timeshare.DeficitRoundRobin` only spends
    deficit it has and idle queues forfeit to exactly zero.
  - **I-PKTS**: fleet-wide, packets accounted (done + dropped, deduping
    ``FlowStats`` objects rack peers share) never
    exceed packets injected.  Per-sNIC conservation is NOT an invariant:
    rack forwarding completes a packet on a *peer* of the sNIC that
    injected it, so the law only sums.
  - **I-STORE**: the sNIC packet store never holds negative bytes, and
    every live NT instance's credit count stays within [0, cfg.credits].
  - **I-BATCH**: on the compute backend, batches injected == batches
    completed + batches queued + batches in flight + batches shed
    (backpressure/tenant-churn sheds are counted, never silent; in-flight
    counts dispatch-ring slots launched but not yet drained by the
    streaming engine — zero at every batch-mode epoch boundary).
  - **I-FAILOVER**: on a fleet coordinator with failover armed, every
    routed deployment points at a healthy shard (unless it was counted
    lost because no healthy shard remained), and the loss/replay
    accounting never goes negative.
  - **I-VMEM**: page frames are conserved (free + owned == total), every
    owned frame's page-table entry points back at it, and the swapped-page
    counter matches the page tables.
  - **I-TRACE**: two replays of one fingerprinted workload trace
    (the workload plane's ``TraceDriver`` results) agree on everything
    the trace seals: trace fingerprint, realized arrival-schedule
    fingerprint, per-epoch tenant census, and per-tenant inject/serve
    counters.  Checked wherever a scenario bench or test replays a trace
    twice under ``REPRO_SANITIZE=1``.
"""
from __future__ import annotations

import os

from repro_torch.core.sched.queues import COST_EPS

from .diagnostics import Diagnostic, Severity, render_text

#: relative slack for float cost accounting (token-bucket costs are floats)
_REL_EPS = 1e-6


def enabled() -> bool:
    """True when the sanitizer should run (read live so tests can toggle)."""
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


class InvariantViolation(AssertionError):
    """A conservation law failed; carries the structured diagnostics."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__("invariant violation:\n" + render_text(diagnostics))


def _raise_if(diags: list[Diagnostic]) -> None:
    if diags:
        raise InvariantViolation(diags)


def _d(rule: str, subject: str, message: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule, Severity.ERROR, subject, message, hint)


# ============================================================== scheduler ====
def scheduler_diags(sched, where: str) -> list[Diagnostic]:
    """I-CREDIT + I-DEFICIT over one FairScheduler's tenant queues."""
    out: list[Diagnostic] = []
    for name, q in sched.queues.items():
        subj = f"{where}/queue:{name}"
        tol = _REL_EPS * max(1.0, abs(q.granted_cost))
        drift = q.granted_cost - (q.served_cost + q.backlog_cost)
        if abs(drift) > tol:
            out.append(_d(
                "I-CREDIT", subj,
                f"cost leak: granted {q.granted_cost:.6g} != served "
                f"{q.served_cost:.6g} + backlog {q.backlog_cost:.6g} "
                f"(drift {drift:.6g})",
                "every push must be matched by a pop or remain in backlog; "
                "look for direct items mutation bypassing push/pop"))
        if q.deficit < -COST_EPS:
            out.append(_d(
                "I-DEFICIT", subj,
                f"WDRR deficit went negative ({q.deficit:.6g})",
                "DeficitRoundRobin must only spend deficit it holds; check "
                "requeue/drain credit handling"))
    return out


def check_scheduler(sched, where: str) -> None:
    _raise_if(scheduler_diags(sched, where))


# =================================================================== sNIC ====
def snic_diags(snic, where: str) -> list[Diagnostic]:
    """Per-device checks: scheduler laws, packet store, NT credits."""
    out = scheduler_diags(snic.sched, where)
    if snic.store_bytes < -1e-6:
        out.append(_d(
            "I-STORE", where,
            f"packet store holds negative bytes ({snic.store_bytes:.6g})",
            "every store_bytes += on parse needs exactly one -= at chain "
            "start"))
    cap = snic.cfg.credits
    for region in snic.regions.regions:
        for inst in region.instances:
            if not 0 <= inst.credits <= cap:
                out.append(_d(
                    "I-STORE",
                    f"{where}/region{region.rid}/nt:{inst.name}",
                    f"NT credit count {inst.credits} outside [0, {cap}]",
                    "credit decrements (dispatch) and increments (release) "
                    "must pair 1:1"))
    return out


def check_snic(snic, where: str) -> None:
    _raise_if(snic_diags(snic, where))


def fleet_packet_diags(snics, where: str) -> list[Diagnostic]:
    """I-PKTS over a fleet: done + dropped <= injected, FlowStats deduped
    by identity (rack peers share the injector's stats object)."""
    injected = sum(s.pid for s in snics)
    seen: set[int] = set()
    accounted = 0
    for s in snics:
        for st in s.stats.values():
            if id(st) in seen:
                continue
            seen.add(id(st))
            accounted += st.pkts_done + st.drops
    if accounted > injected:
        return [_d(
            "I-PKTS", where,
            f"packets accounted ({accounted}) exceed packets injected "
            f"({injected}) across the fleet",
            "a packet was double-counted: check rack forwarding stats "
            "sharing and drop accounting")]
    return []


def check_fleet(snics, where: str) -> None:
    diags: list[Diagnostic] = fleet_packet_diags(snics, where)
    for i, s in enumerate(snics):
        diags.extend(snic_diags(s, f"{where}/snic{i}"))
    _raise_if(diags)


# ================================================================ compute ====
def compute_diags(backend, where: str) -> list[Diagnostic]:
    out = scheduler_diags(backend.sched, where)
    injected = backend.stats["batches"]
    completed = backend.completed_batches
    queued = backend.sched.pending()
    shed = getattr(backend, "shed_batches", 0)
    in_flight = getattr(backend, "inflight_batches", 0)
    if in_flight < 0:
        out.append(_d(
            "I-BATCH", where,
            f"in-flight ring count went negative ({in_flight})",
            "every _stage_group increment must pair with exactly one "
            "_retire decrement"))
    if injected != completed + queued + shed + in_flight:
        out.append(_d(
            "I-BATCH", where,
            f"batch leak: injected {injected} != completed {completed} + "
            f"queued {queued} + shed {shed} + in_flight {in_flight}",
            "every drained item must be dispatched and counted exactly "
            "once per run(); every shed item must bump shed_batches; every "
            "ring slot launched must retire"))
    return out


def check_compute(backend, where: str) -> None:
    _raise_if(compute_diags(backend, where))


# =================================================================== vmem ====
def vmem_diags(vm, where: str) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    if len(vm.free_frames) + len(vm.frame_owner) != vm.n_frames:
        out.append(_d(
            "I-VMEM", where,
            f"frame leak: {len(vm.free_frames)} free + "
            f"{len(vm.frame_owner)} owned != {vm.n_frames} total",
            "release() must return every resident frame to free_frames"))
    for frame, (nt, pg) in vm.frame_owner.items():
        pte = vm.tables.get(nt, {}).get(pg)
        if pte is None or pte.frame != frame:
            out.append(_d(
                "I-VMEM", f"{where}/frame{frame}",
                f"owner map says {nt}:{pg} holds frame {frame} but its PTE "
                f"says {getattr(pte, 'frame', 'missing')}",
                "frame_owner and the page tables must be updated together"))
    swapped = sum(1 for t in vm.tables.values()
                  for pte in t.values() if pte.swapped)
    if vm.swapped_pages != swapped or vm.swapped_pages < 0:
        out.append(_d(
            "I-VMEM", where,
            f"swap counter {vm.swapped_pages} != {swapped} swapped PTEs",
            "swap-in/out and release must keep the counter in sync"))
    return out


def failover_diags(fleet, where: str) -> list[Diagnostic]:
    """I-FAILOVER over a coordinator with health tracking (no-op for a
    fleet without it)."""
    out: list[Diagnostic] = []
    healthy = getattr(fleet, "healthy", None)
    if healthy is None:
        return out
    lost_uids = getattr(fleet, "lost_uids", set())
    for uid, s in fleet.routes.items():
        if not healthy[s] and uid not in lost_uids:
            out.append(_d(
                "I-FAILOVER", f"{where}/dag{uid}",
                f"deployment {uid} still routed to unhealthy shard "
                f"{fleet.shard_names[s]!r}",
                "failover must reroute every resident deployment or count "
                "it lost"))
    counters = dict(getattr(fleet, "lost", {}) or {})
    counters["replayed"] = getattr(fleet, "replayed", 0)
    counters["retries"] = getattr(fleet, "retries", 0)
    for k, v in counters.items():
        if v < 0:
            out.append(_d(
                "I-FAILOVER", where,
                f"failover counter {k!r} went negative ({v})",
                "loss/replay accounting only ever increments"))
    return out


def check_failover(fleet, where: str) -> None:
    _raise_if(failover_diags(fleet, where))


def check_engine(engine, where: str) -> None:
    diags = scheduler_diags(engine.sched, where)
    diags.extend(vmem_diags(engine.vmem, f"{where}/vmem"))
    _raise_if(diags)


# ================================================================= trace ====
def trace_diags(first, second, where: str) -> list[Diagnostic]:
    """I-TRACE over two workload-plane ``DriveResult`` replays of
    the same trace (duck-typed: anything with the same surface works)."""
    out: list[Diagnostic] = []
    if first.trace_fingerprint != second.trace_fingerprint:
        out.append(_d(
            "I-TRACE", where,
            f"replays drove different traces: {first.trace_fingerprint} "
            f"vs {second.trace_fingerprint}",
            "replay the same sealed Trace object (or its dict round-trip)"))
        return out          # everything below is meaningless across traces
    if first.schedule_fingerprint != second.schedule_fingerprint:
        out.append(_d(
            "I-TRACE", where,
            "realized arrival schedules diverged across replays "
            f"({first.schedule_fingerprint} vs "
            f"{second.schedule_fingerprint})",
            "the driver must derive every inject from the sealed trace, "
            "never from live state"))
    if first.census != second.census:
        out.append(_d(
            "I-TRACE", where,
            "per-epoch tenant census diverged across replays",
            "join/leave application must be a pure function of the trace"))
    for kind in ("injected", "served"):
        a, b = getattr(first, kind), getattr(second, kind)
        if a != b:
            drift = sorted(t for t in set(a) | set(b)
                           if a.get(t) != b.get(t))
            out.append(_d(
                "I-TRACE", f"{where}/{kind}",
                f"per-tenant {kind} counters diverged across replays "
                f"(tenants {drift[:5]}{'...' if len(drift) > 5 else ''})",
                "hunt nondeterminism in the backend window (unseeded RNG, "
                "wall-clock coupling) — the trace itself matched"))
    return out


def check_trace(first, second, where: str) -> None:
    _raise_if(trace_diags(first, second, where))


__all__ = [
    "InvariantViolation", "enabled",
    "check_scheduler", "check_snic", "check_fleet", "check_compute",
    "check_engine", "check_failover", "check_trace",
    "scheduler_diags", "snic_diags", "fleet_packet_diags", "compute_diags",
    "vmem_diags", "failover_diags", "trace_diags",
]
