"""Workload plane: seeded datacenter scenarios as replayable data.

The pipeline is ``arrivals + population + churn -> generate() -> Trace
-> TraceDriver -> any backend``:

- :mod:`~repro_torch.workloads.arrivals` — composable rate processes
  (diurnal, flash crowds, on/off, MMPP) sampled with seeded Poisson;
- :mod:`~repro_torch.workloads.population` — heavy-tailed tenant fleets
  (Zipf weights, Pareto packet sizes, power-law DAG mixes over the
  stock NT specs);
- :mod:`~repro_torch.workloads.trace` — the sealed :class:`Trace` artifact
  (sha256 fingerprint, dict round-trip, ``fault_plan()`` compilation of
  churn into the fault plane);
- :mod:`~repro_torch.workloads.generator` — one seeded call tying them
  together;
- :mod:`~repro_torch.workloads.driver` — :class:`TraceDriver`, replaying
  one fingerprinted trace onto sim, compute (batch + stream), serving, or
  a sharded fleet through the public Platform API.

The port of the JAX package's ``repro.workloads``: the same traces, seeds
and fingerprints.  Determinism is load-bearing here: the I-TRACE
invariant cross-checks double-replays under ``REPRO_SANITIZE=1``.
"""
from .arrivals import (Arrival, clip, constant, diurnal,  # noqa: F401
                       flash_crowd, mmpp, onoff, sample_poisson)
from .driver import (DriveResult, TraceDriver,  # noqa: F401
                     default_vpc_params)
from .generator import generate  # noqa: F401
from .population import (SERVE_CHAIN_MIX, VPC_CHAIN_MIX,  # noqa: F401
                         dag_mix, pareto_sizes, zipf_weights)
from .trace import Trace, TraceTenant  # noqa: F401

__all__ = [
    "Arrival", "constant", "diurnal", "flash_crowd", "onoff", "mmpp",
    "clip", "sample_poisson",
    "VPC_CHAIN_MIX", "SERVE_CHAIN_MIX", "zipf_weights", "pareto_sizes",
    "dag_mix",
    "Trace", "TraceTenant", "generate",
    "TraceDriver", "DriveResult", "default_vpc_params",
]
