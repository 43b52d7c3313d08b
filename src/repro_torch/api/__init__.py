"""repro_torch.api — the unified tenant-facing offload API (SuperNIC §3).

Build a network-task DAG declaratively, deploy it through one Platform
facade, and run it::

    from repro_torch.api import ComputeBackend, Platform, VPC_SPECS, nt

    dag = nt("firewall") >> nt("nat") >> nt("chacha20")   # chain
    par = nt("rx") >> (nt("fw") | nt("dedup")) >> nt("tx")  # fork/join

Backends: SimBackend (the event-driven sNIC device model, host Python, the
paper's constants), ComputeBackend (NT names bound to batched PyTorch
code; the VPC chain dispatches to one hand-written CUDA kernel on the card),
with bucket padding, fair coalescing and one device sync per run(), or
pipelined through the streaming dispatch ring with ``stream=True`` /
``inject_stream`` (pinned staging slots, copies on a stream of their own);
ServeBackend (the multi-tenant LLM serving engine, ``cache >> prefill >>
decode``, for dense, MoE, hybrid Mamba and RWKV models, with the hot
kernels hand-written in CUDA); and ShardedBackend (a fleet of any of the
above behind one Platform: consolidation-driven placement, cross-shard
fair scheduling, failover with checkpointed stream state —
``Platform([be0, be1])`` wraps automatically).
"""
from .backend import (Backend, PlatformReport,  # noqa: F401
                      TenantReport, merge_reports)
from .compute_backend import (BUILTIN_COMPUTE_NTS, FUSED_KERNELS,  # noqa: F401
                              VPC_SPECS, WIRE_FIELDS, ComputeBackend,
                              ComputeNT, DispatchRing, bucket_size)
from .dag import (DagError, DagExpr, compile_dag, nt,  # noqa: F401
                  nt_chain, validate_dag)
from .placement import PlacementDecision, Placer  # noqa: F401
from .platform import Deployment, Platform, Tenant  # noqa: F401
from .sharded_backend import ShardedBackend  # noqa: F401
from .sim_backend import SimBackend  # noqa: F401


def __getattr__(name):
    # ServeBackend pulls in the model stack; import it lazily
    if name in ("ServeBackend", "SERVE_SPECS"):
        from . import serve_backend
        return getattr(serve_backend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
