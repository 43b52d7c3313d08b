"""ShardedBackend: one Platform fanned across a fleet of shard backends.

The paper scales one sNIC to a rack (§5) with per-sNIC schedulers plus a
peer control plane that places and migrates chains, so the rack provisions
the *peak of the aggregate* rather than the sum of per-endpoint peaks
(§2, Figs 2-3).  This backend is that layer: it wraps N shard backends
behind the ordinary :class:`~repro_torch.api.backend.Backend` protocol, so
``Platform(ShardedBackend([...]))`` (or just ``Platform([be0, be1])``)
needs no new tenant-facing API.  The port of the JAX package's
``api/sharded_backend.py``: in the port the shards are
:class:`~repro_torch.api.compute_backend.ComputeBackend` instances (one
per GPU, or several on one), in batch or streaming mode; the event-driven
paths below (shards that own an event simulator) are kept for the
simulated sNIC, which the port does not have yet.

Three mechanisms make the fleet one platform:

  - **Placement** (:class:`~repro_torch.api.placement.Placer`): every
    ``deploy`` is routed by measured load — chains whose loads
    anti-correlate pack onto the same shard, correlated aggressors spread
    (scored with
    :func:`repro_torch.core.consolidation.analyze` over the per-tenant
    served/deficit monitors each shard's scheduler already records).
  - **Cross-shard fair sharing**: every shard keeps its own
    :class:`~repro_torch.core.sched.FairScheduler`; a *global* space-share
    epoch collects each scheduler's demand window
    (:meth:`~repro_torch.core.sched.FairScheduler.demand`), solves fleet-wide
    weighted max-min fairness under per-shard capacity constraints
    (:func:`repro_torch.core.sched.cross_shard_epoch`) and applies per-shard
    grants — a tenant gorging on one shard yields its share of another to
    tenants stuck there.
  - **Rebalancing**: when a shard's measured peak-of-aggregate exceeds its
    capacity, the placer proposes deploy-on-new-shard + drain-old moves
    (the rack migration semantics of the JAX package's
    ``core/distributed.py``, lifted to whole backends): the destination
    deploys the same DAG, the routing table flips so new traffic lands
    there, and work already queued on the source drains in place.  On the
    compute substrate per-packet state (e.g. the ChaCha ``ctr``) is
    synthesized at inject time, so a mid-run rebalance never changes any
    packet's bits.

And a fourth makes it survive its shards (the resilience plane):

  - **Failover**: each global epoch the coordinator probes every shard's
    ``capacity()`` as a health heartbeat.  ``health_threshold``
    consecutive misses (or a hard :class:`~repro_torch.faults.FaultError`
    from an inject) mark the shard unhealthy: the placer stops offering it,
    its deployments are re-placed onto survivors (redeploy + route flip +
    state restore from the last checkpoint), journaled batch injects are
    replayed, and in-flight packets are written off in the report's
    ``lost`` ledger.  In-flight injects retry with bounded exponential
    backoff against the post-failover route.  When fleet capacity can no
    longer cover demand for ``shed_after`` consecutive epochs, the
    over-grant backlog is shed (graceful degradation, not collapse).  A
    probed-healthy-again shard rejoins after ``recover_threshold`` clean
    heartbeats.  Faults come from a seeded
    :class:`~repro_torch.faults.FaultPlan`, so the same plan reproduces the
    identical run.

``report()`` merges the per-shard reports (:func:`merge_reports`): fleet
totals per tenant, ``extra["per_shard"]`` breakdowns, the full shard
reports under ``.shards``, and the placement/migration/consolidation/
failover logs under ``extra``.
"""
from __future__ import annotations

import math
from collections import deque

import torch

from repro_torch.analysis import invariants as _sanitize
from repro_torch.core.nt import NTDag, NTSpec
from repro_torch.core.sched import cross_shard_epoch
from repro_torch.faults import (FaultError, FaultInjector, FaultPlan,
                                ShardCrashed, ShardHung)

from .backend import Backend, PlatformReport, merge_reports
from .dag import DagError
from .placement import PlacementDecision, Placer

#: default global epoch = this many device epochs (sim shards); the global
#: solve is host-side work, so it runs coarser than the per-sNIC loop
GLOBAL_EPOCH_FACTOR = 4.0


def _sched_of(shard):
    return getattr(shard, "sched", None)


def _is_event(shard) -> bool:
    """Event-driven shards own an EventSim and advance virtual time."""
    return hasattr(shard, "sim")


def _tensor_tree(tree):
    """Nested-dict tree with scalar leaves -> the same tree with 0-d CPU
    tensor leaves: what the port's CheckpointManager saves, and the ``like``
    template its restore takes.  Integers (the stream counters) become
    int64, the word the port carries u32 values in (``_u32.py``), so a
    restore gives back the exact integer that was saved: nothing is
    narrowed or widened on the way, and the ciphertext after a failover
    continues where the checkpoint left it."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, int) and not isinstance(tree, bool):
        return torch.tensor(tree, dtype=torch.int64)
    return torch.as_tensor(tree).cpu()


class ShardedBackend:
    name = "sharded"

    def __init__(self, shards: list[Backend], *,
                 placer: Placer | None = None,
                 global_epoch_ns: float | None = None,
                 auto_rebalance: bool = True,
                 rebalance_every: int = 4,
                 fault_plan: FaultPlan | None = None,
                 health_threshold: int = 2,
                 recover_threshold: int = 2,
                 max_inject_retries: int = 4,
                 inject_backoff_ns: float = 20_000.0,
                 shed_after: int = 2,
                 shed_headroom: float = 2.0,
                 shed_window_epochs: float = 4.0,
                 checkpoint=None,
                 checkpoint_every: int = 1,
                 journal_cap: int = 4096):
        if not shards:
            raise ValueError("ShardedBackend needs at least one shard")
        self.shards = list(shards)
        # unique shard names (two unnamed SimBackends both say "sim")
        names, seen = [], {}
        for s in self.shards:
            base = getattr(s, "name", "shard")
            k = seen.get(base, 0)
            seen[base] = k + 1
            names.append(base if k == 0 else f"{base}#{k}")
        self.shard_names = names
        caps = [self._capacity_gbps(s) for s in self.shards]
        self.placer = placer or Placer(caps)
        self.capacity_gbps = caps
        self._nominal_gbps = list(caps)
        self.auto_rebalance = auto_rebalance
        self.rebalance_every = max(int(rebalance_every), 1)
        # routing state
        self.dags: dict[int, NTDag] = {}
        self.deploy_kw: dict[int, dict] = {}
        self.routes: dict[int, int] = self.placer.routes     # dag -> shard
        #: every shard a dag was ever deployed on, in visit order
        self.deployed: dict[int, list[int]] = {}
        self.tenant_weights: dict[str, float] = {}
        self.migrations: list[tuple[int, str, str, int]] = []
        #: specs retained fleet-wide so ANY shard — including one added
        #: mid-run — is a valid failover/migration target
        self.specs: dict[str, NTSpec] = {}
        self._registered: list[set[str]] = [set() for _ in self.shards]
        # cross-shard epoch state
        event = [s for s in self.shards if _is_event(s)]
        if global_epoch_ns is None and event:
            global_epoch_ns = GLOBAL_EPOCH_FACTOR * max(
                getattr(s, "epoch_ns", 20_000.0) for s in event)
        self.global_epoch_ns = global_epoch_ns or 80_000.0
        self.global_epochs = 0
        self.last_grants: dict = {}
        self.last_demands: dict = {}
        self._epoch_count = 0
        for s in self.shards:
            defer = getattr(s, "defer_epochs", None)
            if defer is not None:
                defer()              # the fleet epoch owns space sharing now
        # ---------------------------------------------- resilience plane --
        self.health_threshold = max(int(health_threshold), 1)
        self.recover_threshold = max(int(recover_threshold), 1)
        self.max_inject_retries = max(int(max_inject_retries), 0)
        self.inject_backoff_ns = float(inject_backoff_ns)
        self.shed_after = max(int(shed_after), 1)
        self.shed_headroom = float(shed_headroom)
        self.shed_window_epochs = float(shed_window_epochs)
        self.healthy: list[bool] = [True] * len(self.shards)
        self._miss = [0] * len(self.shards)
        self._recover_ok = [0] * len(self.shards)
        self._overload_streak = 0
        self.failovers: list[dict] = []
        self.recoveries: list[tuple[int, str]] = []
        self.lost = {"deployments": 0, "pkts": 0, "injects": 0}
        self.lost_uids: set[int] = set()
        self.replayed = 0
        self.retries = 0
        self.backoff_ns_total = 0.0
        self.shed = {"items": 0, "cost": 0.0}
        self._journal_cap = int(journal_cap)
        #: per-shard inject journal (batch shards only) — on failover the
        #: dead shard's un-run injects replay against the new route
        self._journal: list[deque] = [deque(maxlen=self._journal_cap)
                                      for _ in self.shards]
        self.fault_plan = fault_plan
        self.injector = (FaultInjector(fault_plan, self.shards,
                                       names=self.shard_names, tenancy=self)
                         if fault_plan is not None else None)
        # checkpoint plane: per-deployment NT state (e.g. stream-mode
        # ChaCha ctr) snapshotted each batch epoch so a recovered
        # deployment resumes bit-exact
        if isinstance(checkpoint, (str, bytes)) or hasattr(checkpoint,
                                                           "__fspath__"):
            from repro_torch.checkpoint.manager import CheckpointManager
            checkpoint = CheckpointManager(checkpoint)
        self.checkpoint = checkpoint
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self._ckpt_state: dict[int, dict] = {}
        self._ckpt_like = None
        self._ckpt_steps = 0

    # --------------------------------------------------------------- misc --
    @staticmethod
    def _capacity_gbps(shard) -> float:
        cap = getattr(shard, "capacity", None)
        if callable(cap):
            return float(cap().get("gbps", 100.0))
        return 100.0

    @property
    def region_slots(self):
        slots = [s.region_slots for s in self.shards
                 if getattr(s, "region_slots", None) is not None]
        return min(slots) if slots else None

    def shard_of(self, dag_uid: int) -> Backend:
        return self.shards[self.routes[dag_uid]]

    # ----------------------------------------------------------- protocol --
    def register(self, spec: NTSpec) -> None:
        """Register fleet-wide AND retain the spec, so shards added later
        (spares) and failover targets can be brought up to date — a
        migration must never silently fail on a missing spec."""
        self.specs[spec.name] = spec
        for i, s in enumerate(self.shards):
            s.register(spec)
            self._registered[i].add(spec.name)

    def _ensure_registered(self, i: int) -> None:
        """Bring shard ``i`` up to the fleet's spec set before it receives
        a deployment it has never seen."""
        for name, spec in self.specs.items():
            if name not in self._registered[i]:
                self.shards[i].register(spec)
                self._registered[i].add(name)

    def add_shard(self, backend: Backend) -> int:
        """Join a spare shard mid-run: it inherits every retained spec and
        tenant weight, defers its epochs to the fleet, becomes a placement
        candidate, and (under a fault plan) gets its own seeded
        FaultState.  Returns the new shard index."""
        base = getattr(backend, "name", "shard")
        nm, k = base, 0
        while nm in self.shard_names:
            k += 1
            nm = f"{base}#{k}"
        i = len(self.shards)
        self.shards.append(backend)
        self.shard_names.append(nm)
        cap = self._capacity_gbps(backend)
        self.capacity_gbps.append(cap)
        self._nominal_gbps.append(cap)
        self.placer.add_shard(cap)
        self.healthy.append(True)
        self._miss.append(0)
        self._recover_ok.append(0)
        self._registered.append(set())
        self._journal.append(deque(maxlen=self._journal_cap))
        self._ensure_registered(i)
        for t, w in self.tenant_weights.items():
            backend.add_tenant(t, w)
        defer = getattr(backend, "defer_epochs", None)
        if defer is not None:
            defer()
        if self.injector is not None:
            self.injector.attach(backend, nm)
        return i

    def add_tenant(self, tenant: str, weight: float) -> None:
        """Register (or re-weight) the tenant on EVERY shard's scheduler —
        fleet-wide weights are what the cross-shard epoch solves over."""
        self.tenant_weights[tenant] = weight
        for s in self.shards:
            s.add_tenant(tenant, weight)

    def remove_tenant(self, tenant: str) -> tuple[int, float]:
        """Tenant churn: unregister fleet-wide; each shard sheds the
        tenant's backlog (counted in the shed ledger) but keeps its
        completed-work stats for the final report."""
        self.tenant_weights.pop(tenant, None)
        items, cost = 0, 0.0
        for s in self.shards:
            rm = getattr(s, "remove_tenant", None)
            if rm is None:
                continue
            n, c = rm(tenant)
            items += n
            cost += c
        self.shed["items"] += items
        self.shed["cost"] += cost
        return items, cost

    def deploy(self, dag: NTDag, shard: int | None = None, **kw) -> None:
        """Place the DAG (or honor an explicit ``shard=`` pin) and deploy it
        on the chosen shard backend."""
        if shard is None:
            shard = self.placer.place(dag.tenant, dag.uid).shard
        else:
            if not 0 <= shard < len(self.shards):
                raise DagError(f"shard {shard} out of range "
                               f"(fleet has {len(self.shards)})")
            if not self.healthy[shard]:
                raise DagError(
                    f"shard {shard} ({self.shard_names[shard]}) is "
                    "unhealthy; cannot pin a deploy there")
            self.placer.assign(dag.uid, dag.tenant, shard)
            # pinned deploys still belong in the placement log — routes
            # and decisions must tell one consistent story
            self.placer.decisions.append(PlacementDecision(
                "place", dag.uid, dag.tenant, shard, "pinned by caller"))
        self.dags[dag.uid] = dag
        self.deploy_kw[dag.uid] = dict(kw)
        self.deployed[dag.uid] = [shard]
        self._ensure_registered(shard)
        self.shards[shard].deploy(dag, **kw)

    def inject(self, tenant: str, dag_uid: int, *args, **kw):
        """Route to the deployment's shard.  A hard fault (crash/hang)
        observed here is a definitive health signal: the shard fails over
        immediately and the inject retries against the new route with
        bounded exponential backoff (virtual — accounted, not slept).
        When no survivor can take the deployment the inject is written off
        in the ``lost`` ledger and the fault propagates."""
        if dag_uid not in self.routes:
            raise KeyError(f"DAG {dag_uid} not deployed on any shard")
        attempt = 0
        while True:
            idx = self.routes[dag_uid]
            try:
                out = self.shards[idx].inject(tenant, dag_uid, *args, **kw)
            except (ShardCrashed, ShardHung):
                self.retries += 1
                self._note_backoff(attempt)
                attempt += 1
                self._failover(idx, reason="inject-fault")
                if attempt > self.max_inject_retries or \
                        self.routes.get(dag_uid) == idx or \
                        dag_uid in self.lost_uids:
                    self.lost["injects"] += 1
                    raise
                continue
            if not _is_event(self.shards[idx]):
                self._journal[idx].append((tenant, dag_uid, args, dict(kw)))
            return out

    def _note_backoff(self, attempt: int) -> None:
        """Exponential backoff accounting for a retried inject.  The fleet
        runs on virtual time, so the delay is charged to a ledger (the
        resilience bench reports it) rather than slept."""
        self.backoff_ns_total += self.inject_backoff_ns * (1 << min(attempt,
                                                                    6))

    def _source_sink(self, tenant: str, dag_uid: int, *args, **kw):
        """Sink for attached stochastic sources: a fault mid-emission must
        not unwind the shard's event loop, so it is swallowed and the
        packet written off as lost (failover already ran inside inject)."""
        try:
            return self.inject(tenant, dag_uid, *args, **kw)
        except FaultError:
            self.lost["pkts"] += 1

    def add_source(self, kind: str, tenant: str, dag_uid: int, **kw) -> None:
        """Attach a source on the deployment's current shard, with the sink
        routed back through this backend — so if the deployment later
        migrates, the source's traffic follows the routing table instead of
        staying glued to the shard it was attached on."""
        shard = self.shard_of(dag_uid)
        add_source = getattr(shard, "add_source", None)
        if add_source is None:
            raise NotImplementedError(
                f"shard {shard.name!r} has no traffic sources")
        kw.setdefault("sink", self._source_sink)
        add_source(kind, tenant, dag_uid, **kw)

    def settle(self) -> None:
        for s in self.shards:
            settle = getattr(s, "settle", None)
            if settle is not None:
                settle()

    # ---------------------------------------------------------- migration --
    def migrate(self, dag_uid: int, dst: int) -> bool:
        """Deploy-on-new-shard + drain-old for one deployment: the DAG is
        deployed at ``dst``, the routing table flips so every later inject
        (and source attach) lands there, and work already queued on the old
        shard drains where it is — nothing in flight is dropped or re-run."""
        src = self.routes[dag_uid]
        if dst == src:
            return False
        if not 0 <= dst < len(self.shards):
            raise DagError(f"shard {dst} out of range")
        if not self.healthy[dst]:
            raise DagError(f"shard {dst} ({self.shard_names[dst]}) is "
                           "unhealthy; cannot migrate there")
        dag = self.dags[dag_uid]
        self._ensure_registered(dst)
        if dst not in self.deployed[dag_uid]:
            # first visit only: a re-deploy on a migrate-back would reset
            # the destination's accumulated per-deployment state/results
            self.shards[dst].deploy(dag, **self.deploy_kw[dag_uid])
            self.deployed[dag_uid].append(dst)
        self.placer.assign(dag_uid, dag.tenant, dst)
        self.migrations.append((self.global_epochs, self.shard_names[src],
                                self.shard_names[dst], dag_uid))
        return True

    def rebalance(self) -> list[tuple[int, int, int]]:
        """One placer rebalance pass; executes the proposed moves."""
        moves = []
        for uid, src, dst in self.placer.propose_moves():
            if self.migrate(uid, dst):
                self.placer.record_move(uid, src, dst)
                moves.append((uid, src, dst))
        return moves

    # ----------------------------------------------------------- failover --
    def _inflight_pkts(self, i: int) -> int:
        """Packets queued on shard ``i``'s scheduler(s) — the work a crash
        strands, written off in the lost ledger at failover."""
        s = self.shards[i]
        n = 0
        snics = getattr(s, "snics", None)
        if snics:
            for sn in snics:
                for q in sn.sched.queues.values():
                    n += len(q.items)
            return n
        sched = _sched_of(s)
        if sched is not None:
            for q in sched.queues.values():
                n += len(q.items)
        return n

    def _failover(self, i: int, reason: str = "probe-miss") -> None:
        """Mark shard ``i`` dead and evacuate it: placer stops offering it,
        every deployment routed there is re-placed onto a survivor
        (redeploy + route flip + checkpoint state restore), journaled
        batch injects replay against the new routes, and stranded
        in-flight packets are written off.  A deployment no survivor can
        take is recorded lost — the fleet degrades, it does not crash."""
        if not self.healthy[i]:
            return
        self.healthy[i] = False
        self._miss[i] = 0
        self._recover_ok[i] = 0
        self.placer.disable(i)
        self.placer.set_capacity(i, 0.0)
        self.capacity_gbps[i] = 0.0
        inflight = self._inflight_pkts(i)
        moved, lost = [], []
        for uid, at in list(self.routes.items()):
            if at != i or uid in self.lost_uids:
                continue
            dag = self.dags[uid]
            try:
                dst = self.placer.place(dag.tenant, uid).shard
            except ValueError:          # no enabled shard left
                self.lost["deployments"] += 1
                self.lost_uids.add(uid)
                lost.append(uid)
                continue
            self._ensure_registered(dst)
            if dst not in self.deployed[uid]:
                self.shards[dst].deploy(dag, **self.deploy_kw[uid])
                self.deployed[uid].append(dst)
            self._restore_state(uid, dst)
            self.migrations.append((self.global_epochs, self.shard_names[i],
                                    self.shard_names[dst], uid))
            moved.append(uid)
        replayed = self._replay_journal(i)
        self.lost["pkts"] += inflight
        self.failovers.append({
            "epoch": self._epoch_count, "shard": self.shard_names[i],
            "reason": reason, "moved": moved, "lost": lost,
            "inflight_pkts": inflight, "replayed": replayed})

    def _replay_journal(self, i: int) -> int:
        """Replay the dead shard's journaled (un-run) batch injects against
        the post-failover routes; un-replayable entries join the lost
        ledger."""
        entries = list(self._journal[i])
        self._journal[i].clear()
        n = 0
        for tenant, uid, args, kw in entries:
            if self.routes.get(uid) == i or uid in self.lost_uids:
                continue
            try:
                self.inject(tenant, uid, *args, **kw)
                n += 1
            except FaultError:
                self.lost["injects"] += 1
        self.replayed += n
        return n

    def _recover(self, i: int, cap: dict) -> None:
        """Shard ``i`` probed healthy ``recover_threshold`` times: rejoin
        the placement pool at its probed capacity with a fresh demand
        window (pre-crash demand is void)."""
        self.healthy[i] = True
        self._miss[i] = 0
        self._recover_ok[i] = 0
        g = float(cap.get("gbps", 0.0)) or self._nominal_gbps[i]
        self.capacity_gbps[i] = g
        self.placer.enable(i)
        self.placer.set_capacity(i, g)
        sched = _sched_of(self.shards[i])
        if sched is not None:
            sched.end_window()
        self.recoveries.append((self._epoch_count, self.shard_names[i]))

    def _probe_health(self) -> None:
        """One heartbeat round: probe every shard's ``capacity()``.
        ``health_threshold`` consecutive misses fail the shard over;
        ``recover_threshold`` consecutive successes bring it back.  A
        healthy probe also refreshes the shard's capacity in the placer
        (degraded shards attract proportionally less)."""
        for i, s in enumerate(self.shards):
            cap = getattr(s, "capacity", None)
            if not callable(cap):
                continue
            try:
                c = cap()
            except Exception as e:      # FaultError or a real probe failure
                if self.healthy[i]:
                    self._miss[i] += 1
                    if self._miss[i] >= self.health_threshold:
                        self._failover(i, reason=type(e).__name__)
                else:
                    self._recover_ok[i] = 0
                continue
            if self.healthy[i]:
                self._miss[i] = 0
                g = float(c.get("gbps", self.capacity_gbps[i]))
                self.capacity_gbps[i] = g
                self.placer.set_capacity(i, g)
            else:
                self._recover_ok[i] += 1
                if self._recover_ok[i] >= self.recover_threshold:
                    self._recover(i, c)

    # --------------------------------------------------------- checkpoint --
    def _checkpoint_epoch(self) -> None:
        """Snapshot per-deployment NT state (stream-mode ChaCha ``ctr``,
        …) from every healthy stateful shard.  Kept in memory always;
        persisted through the CheckpointManager (atomic, torn-file-safe)
        when one is attached — that is what failover restores from, so a
        recovered deployment resumes bit-exact."""
        state: dict[int, dict] = {}
        for uid, i in self.routes.items():
            if not self.healthy[i] or uid in self.lost_uids:
                continue
            exp = getattr(self.shards[i], "export_state", None)
            if exp is None:
                continue
            st = exp(uid)
            if st:
                state[uid] = st
        if not state:
            return
        self._ckpt_state = state
        if self.checkpoint is not None and \
                self._epoch_count % self.checkpoint_every == 0:
            tree = _tensor_tree({str(uid): st for uid, st in state.items()})
            self._ckpt_like = tree
            self._ckpt_steps += 1
            self.checkpoint.save(self._ckpt_steps, tree, block=True)

    def _restore_state(self, uid: int, dst: int) -> None:
        """Restore deployment ``uid``'s checkpointed NT state onto shard
        ``dst`` (failover target): durable checkpoint first, in-memory
        snapshot as fallback."""
        imp = getattr(self.shards[dst], "import_state", None)
        if imp is None:
            return
        st = None
        if self.checkpoint is not None and self._ckpt_like is not None:
            try:
                tree, _ = self.checkpoint.restore(None, like=self._ckpt_like)
                st = tree.get(str(uid))
            except (FileNotFoundError, AssertionError):
                st = None
        if st is None:
            st = self._ckpt_state.get(uid)
        if st:
            imp(uid, st)

    # ------------------------------------------------- cross-shard epoch --
    def _shard_window_caps(self, window_ns: float | None) -> dict[int, float]:
        """Per-shard capacity for one global epoch, in cost units (bytes)."""
        out = {}
        for i, s in enumerate(self.shards):
            gbps = self.capacity_gbps[i]
            if window_ns is not None:
                out[i] = gbps / 8.0 * window_ns     # Gb/s * ns -> bytes
            else:
                out[i] = math.inf                   # batched shard: un-paced
        return out

    def _cold_start(self, window_ns: float) -> None:
        """Pace every tenant at its weight-proportional share before the
        first measured window.  Without this the fleet's first window runs
        unpaced and floods the devices with a weight-blind in-flight pool
        that keeps draining 1:1 for several windows after the first real
        grants land."""
        if self._epoch_count or self.global_epochs:
            return
        wsum = sum(self.tenant_weights.values()) or 1.0
        caps = self._shard_window_caps(window_ns)
        for i, s in enumerate(self.shards):
            apply = getattr(s, "apply_grants", None) if _is_event(s) else None
            if apply is not None:
                apply({t: caps[i] * w / wsum
                       for t, w in self.tenant_weights.items()}, window_ns)

    def _global_epoch(self, window_ns: float | None,
                      shards: set[int] | None = None) -> None:
        """Collect the (just-run) shards' scheduler demand windows, solve
        fleet-wide weighted fairness, apply per-shard grants, reset the
        windows.  ``shards`` scopes the epoch to the shards that actually
        advanced: in a mixed fleet the batch shards run *after* the event
        loop, so counting their standing backlog in every per-window event
        epoch would throttle that tenant's sim pacing against phantom
        grants no batch shard can apply.  Unhealthy shards are out of the
        solve entirely — survivors split the fleet's whole grant pool."""
        demands: dict[int, dict[str, float]] = {}
        arrivals: dict[int, dict[str, float]] = {}
        scheds = {}
        for i, s in enumerate(self.shards):
            if shards is not None and i not in shards:
                continue
            if not self.healthy[i]:
                continue
            sched = _sched_of(s)
            if sched is None:
                continue
            scheds[i] = sched
            # solver demand includes standing backlog (work conservation);
            # the placer's consolidation signal is raw arrivals — backlog
            # would smooth the very burst shapes packing decisions feed on
            demands[i] = sched.demand("ingress")
            arrivals[i] = sched.demand("ingress", include_backlog=False)
        # offered-load histories feed the placer (arrivals = what the
        # tenant wanted this window, the consolidation signal of Figs 2-3);
        # zero-arrival windows are real burst-shape signal, so they are
        # recorded even when there is nothing to solve
        total: dict[str, float] = {}
        for i, d in arrivals.items():
            scale = (8.0 / window_ns if window_ns else 0.0)  # bytes -> gbps
            for t, v in d.items():
                total[t] = total.get(t, 0.0) + (v * scale if scale
                                                else v * 8e-9)
        # placer histories sample once per event window (gbps); in a mixed
        # fleet the batch pass is skipped — its unitless per-run arrivals
        # would pollute the time-based profiles the event fleet keeps
        if window_ns is not None or \
                not any(_is_event(s) for s in self.shards):
            for t in self.tenant_weights:
                self.placer.record(t, total.get(t, 0.0))
        if not any(demands.values()):
            self._overload_streak = 0
            for sched in scheds.values():
                sched.end_window()
            return
        grants = cross_shard_epoch(demands, self._shard_window_caps(window_ns),
                                   self.tenant_weights)
        for i, sched in scheds.items():
            sched.end_window()
            shard = self.shards[i]
            apply = getattr(shard, "apply_grants", None)
            if window_ns is not None and apply is not None:
                apply(grants.get(i, {}), window_ns)
        self.last_demands = demands
        self.last_grants = grants
        self.global_epochs += 1
        if window_ns is not None:
            self._maybe_shed(window_ns, demands, grants)
        if _sanitize.enabled():   # fleet-wide conservation at the global
            self._sanitize_shards()  # epoch boundary

    def _maybe_shed(self, window_ns: float, demands: dict,
                    grants: dict) -> None:
        """Graceful degradation: when the fleet's offered load outruns
        surviving capacity by ``shed_headroom``x for ``shed_after``
        consecutive epochs, trim each tenant's standing backlog to a few
        windows' worth of its grant (``shed_window_epochs``).  Shed work is
        counted — on sim shards as FlowStats drops (I-PKTS stays an
        inequality), on batch shards in ``shed_batches`` (the I-BATCH shed
        term) — so conservation laws hold under loss."""
        caps = self._shard_window_caps(window_ns)
        total_cap = sum(caps[i] for i in caps if self.healthy[i])
        total_dem = sum(v for d in demands.values() for v in d.values())
        if total_dem > self.shed_headroom * total_cap:
            self._overload_streak += 1
        else:
            self._overload_streak = 0
            return
        if self._overload_streak < self.shed_after:
            return
        for i in demands:
            shed = getattr(self.shards[i], "shed_backlog", None)
            if shed is None:
                sched = _sched_of(self.shards[i])
                shed = getattr(sched, "shed_backlog", None)
            if shed is None:
                continue
            g = grants.get(i, {})
            for t in list(demands[i]):
                limit = self.shed_window_epochs * g.get(t, 0.0)
                n, c = shed(t, limit)
                self.shed["items"] += n
                self.shed["cost"] += c

    def _sanitize_shards(self) -> None:
        """Run the invariant harness across every shard: packet conservation
        sums over ALL event shards' sNICs (rack forwarding completes packets
        on peers), plus per-shard scheduler/queue laws, plus the failover
        routing law (routes point at healthy shards or are recorded lost)."""
        snics = [sn for s in self.shards for sn in getattr(s, "snics", ())]
        if snics:
            _sanitize.check_fleet(snics, f"{self.name}/fleet")
        for i, s in enumerate(self.shards):
            sched = _sched_of(s)
            if sched is not None and not hasattr(s, "snics"):
                _sanitize.check_scheduler(sched, f"{self.name}/shard{i}")
        _sanitize.check_failover(self, f"{self.name}/failover")

    # ---------------------------------------------------------------- run --
    def run(self, duration_ms: float | None = None,
            duration_ns: float | None = None, settle: bool = False,
            **kw) -> None:
        """Advance the fleet.  Event-driven shards step together in global
        epochs (apply due faults, run each shard one window, probe health,
        then the cross-shard solve + placer sampling, then maybe a
        rebalance pass); batched shards run once and contribute one demand
        window plus a checkpoint of their per-deployment NT state."""
        if settle:
            self.settle()
        event = [i for i, s in enumerate(self.shards) if _is_event(s)]
        batch = [i for i, s in enumerate(self.shards) if not _is_event(s)]
        if event:
            if duration_ns is None:
                dur = (duration_ms if duration_ms is not None else 1.0) \
                    * 1_000_000.0
            else:
                dur = duration_ns
            t = 0.0
            self._cold_start(self.global_epoch_ns)
            while t < dur:
                if self.injector is not None:
                    self.injector.advance(self._epoch_count)
                step = min(self.global_epoch_ns, dur - t)
                for i in event:
                    self.shards[i].run(duration_ns=step)
                t += step
                self._probe_health()
                self._global_epoch(step, shards=set(event))
                self._epoch_count += 1
                if self.auto_rebalance and \
                        self._epoch_count % self.rebalance_every == 0:
                    self.rebalance()
        if batch:
            if self.injector is not None and not event:
                self.injector.advance(self._epoch_count)
            self._probe_health()
            for i in batch:
                self.shards[i].run(**kw)
                faults = getattr(self.shards[i], "faults", None)
                if (faults is None or faults.serving()) and not getattr(
                        self.shards[i], "inflight_batches", 0):
                    # the batch drained AND the streaming ring is empty:
                    # its journaled injects are done.  Entries still in a
                    # ring slot (dispatched, not yet synced) stay journaled
                    # so a crash before their drain replays them.
                    self._journal[i].clear()
            self._checkpoint_epoch()
            self._global_epoch(None, shards=set(batch))
            if not event:
                # batch-only fleets advance one fault epoch per run() call
                self._epoch_count += 1
            if self.auto_rebalance:
                self.rebalance()

    # ------------------------------------------------------------- report --
    def _shard_visit_order(self, tenant: str) -> list[int]:
        """Shards this tenant's deployments landed on, in first-visit order
        (deploy/migration history) — the order its outputs accumulated."""
        order: list[int] = []
        for uid in sorted(self.deployed):
            if self.dags[uid].tenant != tenant:
                continue
            for s in self.deployed[uid]:
                if s not in order:
                    order.append(s)
        return order

    def report(self) -> PlatformReport:
        per_shard = {self.shard_names[i]: s.report()
                     for i, s in enumerate(self.shards)}
        rep = merge_reports(self.name, per_shard)
        for t, tr in rep.tenants.items():
            tr.extra.setdefault("weight", self.tenant_weights.get(t, 1.0))
            # merge_reports concatenates outputs in shard-dict order; a
            # migration to a LOWER-indexed shard would reorder them, so
            # rebuild per tenant in deployment-visit order (deploys happen
            # before the migration's outputs exist, so this is inject order
            # for any single-deployment tenant)
            visit = self._shard_visit_order(t)
            if len(visit) > 1:
                outs: list = []
                for i in visit:
                    srep = per_shard[self.shard_names[i]]
                    if t in srep.tenants:
                        outs.extend(srep.tenants[t].outputs)
                tr.outputs = outs
        rep.extra["n_shards"] = len(self.shards)
        rep.extra["global_epochs"] = self.global_epochs
        rep.extra["placements"] = [str(d) for d in self.placer.decisions]
        rep.extra["migrations"] = list(self.migrations)
        rep.extra["routes"] = {uid: self.shard_names[s]
                               for uid, s in self.routes.items()}
        rep.extra["consolidation"] = self.placer.savings()
        rep.extra["health"] = {self.shard_names[i]: h
                               for i, h in enumerate(self.healthy)}
        rep.extra["failovers"] = list(self.failovers)
        rep.extra["recoveries"] = list(self.recoveries)
        rep.extra["lost"] = dict(self.lost)
        rep.extra["replayed"] = self.replayed
        rep.extra["inject_retries"] = self.retries
        rep.extra["backoff_ns"] = self.backoff_ns_total
        rep.extra["shed"] = dict(self.shed)
        if self.injector is not None:
            rep.extra["faults"] = self.injector.summary()
        return rep


__all__ = ["ShardedBackend"]
