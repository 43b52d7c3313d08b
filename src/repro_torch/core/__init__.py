"""SuperNIC core: the paper's contribution as a reusable policy library.

The port carries the parts the compute datapath needs:

  - nt:            NT/DAG/packet data model, bitstream enumeration
  - drf:           run-time-monitored weighted Dominant Resource Fairness
  - policy:        reusable control loops (DRF admission, autoscalers)
  - sched:         the substrate-agnostic fair chain scheduler (per-tenant
                   queues, WDRR time sharing, epoch DRF space sharing)
  - vmem:          paged virtual memory and the per-block fast-memory budget

The sNIC device model, regions, the rack platform, consolidation and the
event simulator are not ported yet.
"""
from .drf import drf_allocate  # noqa: F401
from .nt import ChainProgram, NTDag, NTSpec, Packet, enumerate_programs  # noqa: F401
from .policy import DRFAdmission, StepScaler, UtilizationScaler  # noqa: F401
from .sched import FairScheduler, SchedConfig, TenantQueue  # noqa: F401
from .vmem import OutOfMemory, VirtualMemory  # noqa: F401
