"""The backend protocol every substrate implements, plus the typed results
``Platform.report()`` returns.

The port has two substrates so far:
:class:`~repro_torch.api.compute_backend.ComputeBackend`, NT names bound to
batched PyTorch code and, for the VPC chain, to one hand-written CUDA
kernel; and :class:`~repro_torch.api.serve_backend.ServeBackend`, the LLM
serving engine.  The event-simulated sNIC implements the same protocol in
the JAX package and has not been ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from repro_torch.core.nt import NTDag, NTSpec


@dataclass
class TenantReport:
    """Per-tenant results in common units; ``outputs`` carries the
    backend-specific payloads (result arrays, finished requests, ...)."""
    tenant: str
    backend: str = ""
    pkts_done: int = 0
    bytes_done: float = 0.0
    drops: int = 0
    mean_latency_us: float = 0.0
    p99_latency_us: float = 0.0
    gbps: float = 0.0
    outputs: list = field(default_factory=list)
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class PlatformReport:
    backend: str
    duration_ns: float = 0.0
    tenants: dict[str, TenantReport] = field(default_factory=dict)
    extra: dict[str, Any] = field(default_factory=dict)
    #: per-shard breakdown (sharded backends only): shard name -> the
    #: shard's own full report, in shard order
    shards: dict[str, "PlatformReport"] = field(default_factory=dict)

    def __getitem__(self, tenant: str) -> TenantReport:
        return self.tenants[tenant]

    @property
    def total_gbps(self) -> float:
        return sum(t.gbps for t in self.tenants.values())

    @property
    def total_pkts(self) -> int:
        return sum(t.pkts_done for t in self.tenants.values())


def merge_reports(backend_name: str,
                  reports: dict[str, "PlatformReport"]) -> "PlatformReport":
    """Merge per-shard reports into one fleet view with per-shard breakdowns.

    Counters (packets, bytes, drops, Gbps) sum; mean latency is the
    pkts-weighted mean; p99 is the worst shard's p99 (conservative — the raw
    samples live in the per-shard reports); ``outputs`` concatenate in shard
    order, so a deployment migrated from shard *i* to shard *j > i* keeps
    its results in inject order.  Each merged tenant's
    ``extra["per_shard"]`` maps shard name -> that shard's scalar stats, and
    the full per-shard reports stay attached under ``.shards``.
    """
    out = PlatformReport(backend=backend_name,
                         duration_ns=max((r.duration_ns
                                          for r in reports.values()),
                                         default=0.0),
                         shards=dict(reports))
    for shard_name, rep in reports.items():
        for name, tr in rep.tenants.items():
            dst = out.tenants.setdefault(
                name, TenantReport(tenant=name, backend=backend_name))
            lat_pkts = max(tr.pkts_done, 1 if tr.mean_latency_us else 0)
            prev_pkts = dst.extra.get("_lat_pkts", 0)
            if lat_pkts:
                dst.mean_latency_us = (
                    (dst.mean_latency_us * prev_pkts
                     + tr.mean_latency_us * lat_pkts)
                    / (prev_pkts + lat_pkts))
                dst.extra["_lat_pkts"] = prev_pkts + lat_pkts
            dst.p99_latency_us = max(dst.p99_latency_us, tr.p99_latency_us)
            dst.pkts_done += tr.pkts_done
            dst.bytes_done += tr.bytes_done
            dst.drops += tr.drops
            dst.gbps += tr.gbps
            dst.outputs.extend(tr.outputs)
            if "weight" in tr.extra:
                dst.extra["weight"] = tr.extra["weight"]
            dst.extra.setdefault("per_shard", {})[shard_name] = {
                "pkts_done": tr.pkts_done, "bytes_done": tr.bytes_done,
                "drops": tr.drops, "gbps": tr.gbps,
                "mean_latency_us": tr.mean_latency_us,
                "p99_latency_us": tr.p99_latency_us,
            }
    for tr in out.tenants.values():
        tr.extra.pop("_lat_pkts", None)
    return out


@runtime_checkable
class Backend(Protocol):
    """What a substrate must provide to sit behind the Platform facade.

    ``deploy`` receives an already-compiled and validated :class:`NTDag`
    (the Platform runs the builder + spec validation); ``inject`` receives
    whatever traffic unit the substrate consumes — packet sizes (sim),
    packet-field arrays (compute), token prompts (serve).
    """

    name: str

    def register(self, spec: NTSpec) -> None:
        """Make an NT available (specs dict, kernel binding, ...)."""
        ...

    def add_tenant(self, tenant: str, weight: float) -> None:
        ...

    def deploy(self, dag: NTDag, **kw) -> None:
        ...

    def inject(self, tenant: str, dag_uid: int, *args, **kw):
        ...

    def run(self, **kw) -> None:
        ...

    def report(self) -> PlatformReport:
        ...
