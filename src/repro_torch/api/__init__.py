"""repro_torch.api — the unified tenant-facing offload API (SuperNIC §3).

Build a network-task DAG declaratively, deploy it through one Platform
facade, and run it::

    from repro_torch.api import ComputeBackend, Platform, VPC_SPECS, nt

    dag = nt("firewall") >> nt("nat") >> nt("chacha20")   # chain
    par = nt("rx") >> (nt("fw") | nt("dedup")) >> nt("tx")  # fork/join

Backends ported so far: ComputeBackend (NT names bound to batched PyTorch
code; the VPC chain dispatches to one hand-written CUDA kernel on the card),
with bucket padding, fair coalescing and one device sync per run(); and
ServeBackend (the multi-tenant LLM serving engine, ``cache >> prefill >>
decode``, for dense, MoE and hybrid Mamba models, with prefill attention,
the expert matmuls and the selective scan in hand-written CUDA kernels).
The sim and sharded backends of the JAX package are still to be ported.
"""
from .backend import (Backend, PlatformReport,  # noqa: F401
                      TenantReport, merge_reports)
from .compute_backend import (BUILTIN_COMPUTE_NTS, FUSED_KERNELS,  # noqa: F401
                              VPC_SPECS, WIRE_FIELDS, ComputeBackend,
                              ComputeNT, bucket_size)
from .dag import (DagError, DagExpr, compile_dag, nt,  # noqa: F401
                  nt_chain, validate_dag)
from .platform import Deployment, Platform, Tenant  # noqa: F401


def __getattr__(name):
    # ServeBackend pulls in the model stack; import it lazily
    if name in ("ServeBackend", "SERVE_SPECS"):
        from . import serve_backend
        return getattr(serve_backend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
