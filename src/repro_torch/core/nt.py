"""Network-task (NT) data model: specs, DAGs, packets, instances.

Terminology follows the paper (§3-4):
  - NTSpec: one deployable network task (an FPGA netlist in the paper; a
    jitted stage program in the ML runtime).  Its service model is
    ``fixed_ns + bytes * ns_per_byte`` with ``max_gbps`` line rate.
  - NTDag: a user-supplied DAG over deployed NTs.  We represent it as a list
    of *stages*; each stage is a list of parallel *branches*; each branch is a
    sequence of NT names (an *NT chain*).  Packets fork at a stage into its
    branches and join in the synchronization buffer before the next stage.
  - ChainProgram: a concrete NT sequence placeable into one region (a
    generated bitstream in the paper).  Branch execution may *skip* NTs, so a
    program can serve any subsequence of its chain.
  - Packet: unit of scheduling (header + optional payload in packet store).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

GBPS = 1e9 / 8  # bytes per second per Gbps


@dataclass(frozen=True)
class NTSpec:
    name: str
    max_gbps: float = 100.0          # per-instance line rate
    fixed_ns: float = 50.0           # per-packet pipeline latency
    area: int = 1                    # region slots consumed
    needs_payload: bool = False      # must fetch payload from packet store
    state_bytes: int = 0             # on-board memory footprint (vmem)
    bitstream_bytes: int = 4 << 20   # ~4 MB (paper: <5 MB)
    shared: bool = False             # stateful NT usable across tenants
    #                                  (opt-out of the §3 isolation rule;
    #                                  e.g. an engine-wide KV cache pool)

    @property
    def ns_per_byte(self) -> float:
        return 1.0 / (self.max_gbps * GBPS) * 1e9


@dataclass(frozen=True)
class NTDag:
    """stages[i] = list of parallel branches; branch = tuple of NT names."""
    uid: int
    tenant: str
    stages: tuple[tuple[tuple[str, ...], ...], ...]

    @staticmethod
    def chain(uid: int, tenant: str, names: tuple[str, ...]) -> "NTDag":
        return NTDag(uid, tenant, (((tuple(names)),),))

    def all_nts(self) -> list[str]:
        out = []
        for stage in self.stages:
            for branch in stage:
                out.extend(branch)
        return out


@dataclass
class Packet:
    pid: int
    tenant: str
    dag_uid: int
    size_bytes: int
    arrival_ns: float = 0.0
    # bookkeeping
    ingress_ns: float = 0.0          # after rate limiter / parser
    done_ns: float = 0.0
    sched_visits: int = 0            # times through the central scheduler
    hops: int = 0                    # remote-sNIC detours

    @property
    def latency_ns(self) -> float:
        return self.done_ns - self.arrival_ns


@dataclass
class NTInstance:
    """A running NT inside a region's chain program."""
    spec: NTSpec
    region_id: int
    slot: int                        # position within the region's program
    credits: int = 8                 # paper Fig 14: 8 credits reach 100G
    busy_until_ns: float = 0.0
    # per-epoch monitors (reset by the control loop)
    demand_bytes: float = 0.0        # offered load (measured pre-credit)
    served_bytes: float = 0.0
    served_pkts: int = 0

    @property
    def name(self) -> str:
        return self.spec.name


@dataclass
class ChainProgram:
    """An NT sequence that fits one region (a generated 'bitstream')."""
    names: tuple[str, ...]
    bitstream_bytes: int = 4 << 20

    def covers(self, branch: tuple[str, ...]) -> bool:
        """True if ``branch`` is a subsequence of this program (skip support)."""
        it = iter(self.names)
        return all(any(n == b for n in it) for b in branch)


def enumerate_programs(dags: list[NTDag], specs: dict[str, NTSpec],
                       region_slots: int) -> list[ChainProgram]:
    """Bitstream generation (§4.3): all contiguous sub-chains of every branch
    that fit in one region, deduplicated.  Mirrors Figure 6's enumeration."""
    seen: dict[tuple[str, ...], ChainProgram] = {}
    for dag in dags:
        for stage in dag.stages:
            for branch in stage:
                n = len(branch)
                for i, j in itertools.combinations(range(n + 1), 2):
                    sub = branch[i:j]
                    size = sum(specs[x].area for x in sub)
                    if size <= region_slots and sub not in seen:
                        bits = sum(specs[x].bitstream_bytes for x in sub)
                        seen[sub] = ChainProgram(sub, bits)
    return list(seen.values())
