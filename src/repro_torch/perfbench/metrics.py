"""Flatten BENCH_*.json snapshots into comparable metric series.

A snapshot is arbitrary nested JSON; a *metric* is any numeric leaf,
addressed by its dotted path (``scenarios.diurnal.sim.gbps``).  A leaf
that is a list of numbers is treated as repeats of one metric — that is
how ``perfbench run --repeats N`` stores noise for the variance gate.
Several snapshots of the same bench can also be pooled into one series
(one sample per file).  Keys starting with ``_`` and obviously
non-metric leaves (strings, fingerprints, booleans) are skipped.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Stat:
    """Per-metric summary over >= 1 samples."""
    mean: float
    cv: float               # stdev / |mean|; 0.0 for single samples
    n: int
    samples: tuple[float, ...] = ()

    @classmethod
    def of(cls, samples: list[float]) -> "Stat":
        n = len(samples)
        mean = sum(samples) / n
        if n < 2 or mean == 0.0:
            return cls(mean=mean, cv=0.0, n=n, samples=tuple(samples))
        var = sum((s - mean) ** 2 for s in samples) / (n - 1)
        return cls(mean=mean, cv=math.sqrt(var) / abs(mean), n=n,
                   samples=tuple(samples))


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(float(x))


def flatten(obj, prefix: str = "") -> dict[str, list[float]]:
    """Dotted-path numeric leaves.  List-of-number leaves become repeat
    samples; other lists recurse by index."""
    out: dict[str, list[float]] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            k = str(k)
            if k.startswith("_"):
                continue
            path = f"{prefix}.{k}" if prefix else k
            out.update(flatten(v, path))
    elif isinstance(obj, list):
        if obj and all(_is_number(v) for v in obj):
            out[prefix] = [float(v) for v in obj]
        else:
            for i, v in enumerate(obj):
                out.update(flatten(v, f"{prefix}.{i}"))
    elif _is_number(obj):
        out[prefix] = [float(obj)]
    return out


def load_snapshot(path: str | Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_stats(snapshots: list[dict]) -> dict[str, Stat]:
    """Pool one or more snapshots of the same bench into per-metric
    stats.  A ``perfbench run`` snapshot (``{"repeats": [...]}``
    envelope) contributes one sample per repeat; plain snapshots
    contribute one sample per file (list leaves contribute each
    element)."""
    pooled: dict[str, list[float]] = {}
    for snap in snapshots:
        body = snap.get("repeats") if isinstance(snap, dict) else None
        parts = body if isinstance(body, list) and body else [snap]
        for part in parts:
            for path, samples in flatten(part).items():
                pooled.setdefault(path, []).extend(samples)
    return {path: Stat.of(s) for path, s in sorted(pooled.items())}


__all__ = ["Stat", "flatten", "load_snapshot", "metric_stats"]
