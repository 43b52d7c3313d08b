"""perfbench: the cross-commit performance-regression gate of the port.

Three layers over the repo's ``BENCH_*.json`` snapshot convention:

- :mod:`~repro_torch.perfbench.metrics` — flatten any snapshot into
  dotted-path numeric series (lists = repeats) with per-metric mean/CV;
- :mod:`~repro_torch.perfbench.compare` — the variance-aware gate: a metric
  regresses only when its bad-direction delta exceeds
  ``max(threshold, k * cv)``, so noise earns a wider gate and a real
  slowdown still fails;
- :mod:`~repro_torch.perfbench.trajectory` +
  :mod:`~repro_torch.perfbench.bisect` —
  the append-only ``BENCH_trajectory.json`` ledger and threshold-based
  ``good..bad`` bisection that re-runs a named smoke bench per probe.

CLI: ``python -m repro_torch.perfbench {compare,run,bisect}`` (see
``__main__``).  A copy of the JAX package's ``repro.perfbench`` (stdlib
only): direction inference, the ``max(threshold, k * cv)`` gate, the
``--only`` / ``--skip`` filters and the trajectory bound are the same, so
one snapshot pair gates the same way in both packages.  Only the bench
registry differs: ``__main__.SNAPSHOT_RUNNERS`` starts empty.
"""
from .bisect import bisect_first_bad, list_commits  # noqa: F401
from .compare import (CompareResult, MetricDelta,  # noqa: F401
                      compare, direction, format_report)
from .metrics import Stat, flatten, load_snapshot, metric_stats  # noqa: F401
from .trajectory import (append_entry, current_commit,  # noqa: F401
                         load_trajectory)

__all__ = [
    "Stat", "flatten", "load_snapshot", "metric_stats",
    "compare", "direction", "CompareResult", "MetricDelta",
    "format_report",
    "append_entry", "current_commit", "load_trajectory",
    "bisect_first_bad", "list_commits",
]
