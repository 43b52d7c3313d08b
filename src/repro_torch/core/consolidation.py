"""Consolidation economics (§2, C1): sum-of-peaks vs peak-of-aggregate.

The paper's Figures 2-3 compare three provisioning policies over per-endpoint
load timelines:
  - ``sum_of_peaks``      : every endpoint provisions its own peak;
  - ``peak_of_aggregate`` : one pool provisions the peak of the summed load
    (what one sNIC achieves for its endpoints — and the rack of sNICs for
    the whole rack, §5);
  - ``sum_of_rack_peaks`` : per-rack pools (Fig 3's middle bar).

Inputs are load matrices (endpoints x time).  ``synthetic_trace`` generates
bursty fluctuating loads (on/off + lognormal noise + optional diurnal phase
shifts) that match the qualitative shape of the Gao et al. disaggregated
traces and the FB/Alibaba data-center traces.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ConsolidationReport:
    sum_of_peaks: float
    peak_of_aggregate: float
    mean_aggregate: float

    @property
    def savings(self) -> float:
        """sum-of-peaks / peak-of-aggregate (paper: 1.1-2.4x at 5 endpoints)."""
        return self.sum_of_peaks / max(self.peak_of_aggregate, 1e-12)


def analyze(loads: np.ndarray) -> ConsolidationReport:
    """loads: (n_endpoints, T) nonnegative load samples."""
    loads = np.asarray(loads, dtype=np.float64)
    agg = loads.sum(axis=0)
    return ConsolidationReport(
        sum_of_peaks=float(loads.max(axis=1).sum()),
        peak_of_aggregate=float(agg.max()),
        mean_aggregate=float(agg.mean()))


def rack_analysis(loads: np.ndarray, rack_size: int) -> dict:
    """Fig 3: no consolidation vs rack-level vs global consolidation.

    ``rack_size`` need not divide the endpoint count — the tail rack simply
    holds the remainder (a rack of 2 over 5 endpoints is racks of 2, 2, 1).
    """
    loads = np.asarray(loads, dtype=np.float64)
    if loads.ndim != 2 or loads.shape[0] == 0 or loads.shape[1] == 0:
        raise ValueError(
            f"loads must be a non-empty (n_endpoints, T) matrix; got shape "
            f"{loads.shape}")
    if not float(rack_size).is_integer() or int(rack_size) <= 0:
        raise ValueError(
            f"rack_size must be a positive integer, got {rack_size!r}")
    rack_size = int(rack_size)
    n = loads.shape[0]
    racks = [loads[i:i + rack_size] for i in range(0, n, rack_size)]
    per_rack_peaks = [float(r.sum(axis=0).max()) for r in racks]
    rep = analyze(loads)
    return {
        "sum_of_endpoint_peaks": rep.sum_of_peaks,
        "sum_of_rack_peaks": float(sum(per_rack_peaks)),
        "peak_of_aggregate": rep.peak_of_aggregate,
        "rack_saving": rep.sum_of_peaks / max(sum(per_rack_peaks), 1e-12),
        "global_saving": rep.savings,
    }


def synthetic_trace(n_endpoints: int, T: int, *, seed: int = 0,
                    base: float = 2.0, peak: float = 40.0,
                    burst_prob: float = 0.08, burst_len: int = 8,
                    diurnal: bool = False) -> np.ndarray:
    """Bursty per-endpoint loads whose peaks do not align (§2.1-2.2)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_endpoints, T))
    for i in range(n_endpoints):
        lvl = base * np.exp(rng.normal(0, 0.4, T))
        t = 0
        while t < T:
            if rng.random() < burst_prob:
                ln = rng.integers(1, burst_len + 1)
                amp = peak * np.exp(rng.normal(0, 0.25))
                lvl[t:t + ln] += amp
                t += ln
            else:
                t += 1
        if diurnal:
            phase = rng.uniform(0, 2 * math.pi)
            lvl *= 1.0 + 0.5 * np.sin(
                2 * math.pi * np.arange(T) / T * 2 + phase)
        out[i] = lvl
    return out


def fb_kv_load_trace(n_endpoints: int, T: int, *, seed: int = 0,
                     median_gbps: float = 24.0,
                     p95_gbps: float = 32.0) -> np.ndarray:
    """Per-endpoint load timeline matching the FB 2012 KV trace's reported
    quantiles (§7.1.3: median 24 Gbps, 95th percentile 32 Gbps)."""
    rng = np.random.default_rng(seed)
    sigma = (math.log(p95_gbps) - math.log(median_gbps)) / 1.6449
    out = median_gbps * np.exp(
        rng.normal(0.0, sigma, size=(n_endpoints, T)))
    # sprinkle short 2-3x bursts (bursty tail of the trace)
    for i in range(n_endpoints):
        for _ in range(max(1, T // 50)):
            t = rng.integers(0, T)
            out[i, t:t + 2] *= rng.uniform(2.0, 3.0)
    return out
