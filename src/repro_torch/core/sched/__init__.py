"""Substrate-agnostic multi-tenant fair chain scheduler (paper §4.4).

SuperNIC's management plane combines fair **space** sharing (epoch-driven,
run-time-monitored DRF over every internal resource) with fair **time**
sharing (the order in which queued work is actually served) of heterogeneous
resources.  Before this package existed that logic was re-implemented, in
three dialects, by every substrate that schedules real work; now it is one
reusable subsystem:

  - :mod:`queues`     — per-tenant ingress queues with byte/token credit
                        accounting (token-bucket pacing, backlog caps,
                        served/ drop monitors);
  - :mod:`timeshare`  — weighted deficit round-robin service order;
  - :mod:`spaceshare` — epoch-driven DRF grants built on
                        :class:`repro_torch.core.policy.DRFAdmission`;
  - :mod:`scheduler`  — the :class:`FairScheduler` facade with pluggable
                        ``Clock`` / ``Capacity`` / ``Scale`` hooks.

The same :class:`FairScheduler` drives all three substrates:

  =================  =======================  ============================
  substrate          work unit / cost         time units (Clock hook)
  =================  =======================  ============================
  sNIC device model  packet / wire bytes      simulated ns (EventSim.now)
  ComputeBackend     packet batch / bytes     host seconds (perf_counter)
  serving Engine     request / tokens+pages   host seconds (time.time)
  =================  =======================  ============================

so any future substrate (the ROADMAP's sharding / multi-backend lane) gets
tenancy by instantiating one object instead of re-deriving the paper's §4.4.

For a *fleet* of shards (one FairScheduler each), :func:`cross_shard_epoch`
is the global space-share solve: each shard exports its window's demand
vector (:meth:`FairScheduler.demand`), the coordinator solves fleet-wide
weighted max-min fairness under per-shard capacity constraints, applies the
per-shard grants, and resets the windows (:meth:`FairScheduler.end_window`).
"""
from .queues import QueueItem, TenantQueue  # noqa: F401
from .scheduler import (Clock, FairScheduler, Scale,  # noqa: F401
                        SchedConfig, cross_shard_epoch)
from .spaceshare import SpaceShare  # noqa: F401
from .timeshare import DeficitRoundRobin  # noqa: F401
