"""SuperNIC core: the paper's contribution as a reusable policy library.

  - nt:            NT/DAG/packet data model, bitstream enumeration
  - drf:           run-time-monitored weighted Dominant Resource Fairness
  - policy:        reusable control loops (DRF admission, autoscalers)
  - sched:         the substrate-agnostic fair chain scheduler (per-tenant
                   queues, WDRR time sharing, epoch DRF space sharing)
  - regions:       region manager (victim cache, PR-cost-aware launching)
  - vmem:          paged virtual memory w/ over-subscription + remote swap,
                   and the per-block fast-memory budget
  - snic:          the sNIC device (scheduler, credits, fork/join, control)
  - distributed:   rack-scale platform (migration, passthrough, mem pooling)
  - consolidation: sum-of-peaks vs peak-of-aggregate economics
  - sim:           deterministic event kernel + paper constants + sources

All of it is host Python, the same code as the JAX package's ``core``.
"""
from .consolidation import analyze, rack_analysis  # noqa: F401
from .distributed import Rack, make_rack  # noqa: F401
from .drf import drf_allocate  # noqa: F401
from .nt import ChainProgram, NTDag, NTSpec, Packet, enumerate_programs  # noqa: F401
from .policy import DRFAdmission, StepScaler, UtilizationScaler  # noqa: F401
from .regions import RegionManager, RegionState  # noqa: F401
from .sched import FairScheduler, SchedConfig, TenantQueue  # noqa: F401
from .sim import PAPER, EventSim, FlowStats  # noqa: F401
from .snic import SNIC, SNICConfig  # noqa: F401
from .vmem import OutOfMemory, VirtualMemory  # noqa: F401
