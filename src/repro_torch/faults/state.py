"""FaultState: the per-backend switchboard every datapath consults.

Backends own ``self.faults`` (``None`` when no plan is armed — the hooks
cost one attribute check on the hot path).  The :class:`FaultInjector`
attaches one state per shard, seeded from the plan seed + shard index so
probabilistic faults (drop/corrupt) are reproducible per shard.
"""
from __future__ import annotations

import random
from typing import Iterable

from .errors import NTKernelFault, ShardCrashed, ShardHung


class FaultState:
    def __init__(self, name: str, seed: int = 0):
        self.name = name
        self.rng = random.Random(seed)
        # armed faults
        self.crashed = False
        self.hung = False
        self.degrade = 1.0          # capacity multiplier
        self.drop_prob = 0.0
        self.corrupt_prob = 0.0
        self.nt_faults: set[str] = set()
        # observability
        self.drops = 0
        self.corrupted = 0
        self.nt_errors = 0
        self.stream_interrupts = 0

    # ------------------------------------------------------------- queries --
    def serving(self) -> bool:
        """Does the shard make forward progress this window?"""
        return not (self.crashed or self.hung)

    def check_probe(self) -> None:
        """Health probes cannot tell a hang from a crash: both miss."""
        if self.crashed:
            raise ShardCrashed(self.name)
        if self.hung:
            raise ShardHung(self.name)

    def scale_capacity(self, value: float) -> float:
        return value * self.degrade

    def gate_stream(self) -> bool:
        """Streaming-epoch gate: False (and counted) when the shard cannot
        make forward progress.  A streaming loop parks instead of raising —
        queued work stays on the fair queues and, on a fleet, in the
        coordinator's inject journal, so a failover replays exactly the
        batches that never reached a ring slot."""
        if not self.serving():
            self.stream_interrupts += 1
            return False
        return True

    def gate_inject(self, tenant: str, nts: Iterable[str] = ()) -> str:
        """Called at the top of every backend ``inject``.

        Returns ``"ok"`` / ``"drop"`` / ``"corrupt"``; raises for crash,
        hang, and armed NT kernel faults.  Drop means the packet never
        reached the shard — it is counted here and charged to nobody's
        conservation law (pre-NIC wire loss).
        """
        if self.crashed:
            raise ShardCrashed(self.name)
        if self.hung:
            raise ShardHung(self.name)
        if self.nt_faults:
            hit = self.nt_faults.intersection(nts)
            if hit:
                self.nt_errors += 1
                raise NTKernelFault(sorted(hit)[0])
        if self.drop_prob > 0.0 and self.rng.random() < self.drop_prob:
            self.drops += 1
            return "drop"
        if self.corrupt_prob > 0.0 and self.rng.random() < self.corrupt_prob:
            self.corrupted += 1
            return "corrupt"
        return "ok"

    # -------------------------------------------------------------- counts --
    def summary(self) -> dict:
        return {
            "crashed": self.crashed, "hung": self.hung,
            "degrade": self.degrade, "drops": self.drops,
            "corrupted": self.corrupted, "nt_errors": self.nt_errors,
            "stream_interrupts": self.stream_interrupts,
        }
