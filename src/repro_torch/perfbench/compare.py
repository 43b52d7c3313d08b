"""Variance-aware snapshot comparison: the cross-commit perf gate.

The gate answers one question per metric: *is the delta between baseline
and candidate larger than what this metric's own noise explains?*  A
metric regresses only when its relative delta (in the metric's bad
direction) exceeds ``max(threshold, k * cv)`` where ``cv`` is the worst
coefficient of variation seen on either side — the benchalot-style rule
that keeps a 3-repeat smoke run from crying wolf on jitter while still
catching a genuine 2x slowdown with zero repeats.

Metric direction is classified from the dotted path: throughput-like
names regress when they *drop*, latency-like names when they *rise*,
anything unrecognized is informational only (reported, never gating).
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field

from .metrics import Stat, metric_stats

#: path fragments that mark a higher-is-better metric
_HIGHER = ("per_s", "gbps", "tok_s", "speedup", "savings", "jain",
           "delivered", "ratio", "frac", "served", "pkts_done",
           "bytes_done", "goodput", "hit_rate", "overlap", "survived")
#: path fragments that mark a lower-is-better metric
_LOWER = ("latency", "_us", "_ms", "p50", "p99", "err", "drops", "lost",
          "retries", "misses", "interrupts", "recovery_epochs",
          "compiles", "stalls", "shed", "violations", "wait")


def direction(path: str) -> str:
    """'higher' | 'lower' | 'info' for one dotted metric path."""
    low = path.lower()
    # the most specific (longest) matching fragment wins, so
    # "drops_ratio" gates as a drop-count (lower) not a ratio (higher)
    best, verdict = 0, "info"
    for frag in _HIGHER:
        if frag in low and len(frag) > best:
            best, verdict = len(frag), "higher"
    for frag in _LOWER:
        if frag in low and len(frag) > best:
            best, verdict = len(frag), "lower"
    return verdict


@dataclass
class MetricDelta:
    """One metric's baseline-vs-candidate verdict."""
    path: str
    direction: str
    base: Stat
    cand: Stat
    delta: float            # signed relative change, + = candidate higher
    gate: float             # the threshold actually applied
    verdict: str            # 'ok' | 'regressed' | 'improved' | 'info'


@dataclass
class CompareResult:
    deltas: list[MetricDelta] = field(default_factory=list)
    only_base: list[str] = field(default_factory=list)
    only_cand: list[str] = field(default_factory=list)

    @property
    def regressions(self) -> list[MetricDelta]:
        return [d for d in self.deltas if d.verdict == "regressed"]

    @property
    def improvements(self) -> list[MetricDelta]:
        return [d for d in self.deltas if d.verdict == "improved"]

    @property
    def passed(self) -> bool:
        return not self.regressions

    def to_dict(self) -> dict:
        return {
            "pass": self.passed,
            "regressions": [
                {"metric": d.path, "base": d.base.mean, "cand": d.cand.mean,
                 "delta": round(d.delta, 4), "gate": round(d.gate, 4)}
                for d in self.regressions],
            "improvements": [
                {"metric": d.path, "base": d.base.mean, "cand": d.cand.mean,
                 "delta": round(d.delta, 4)}
                for d in self.improvements],
            "compared": len(self.deltas),
            "only_base": self.only_base,
            "only_cand": self.only_cand,
        }


def _selected(path: str, only: list[str], skip: list[str]) -> bool:
    if only and not any(fnmatch.fnmatch(path, pat) or pat in path
                        for pat in only):
        return False
    return not any(fnmatch.fnmatch(path, pat) or pat in path
                   for pat in skip)


def compare(base_snapshots: list[dict], cand_snapshots: list[dict], *,
            threshold: float = 0.10, k: float = 3.0,
            only: list[str] | None = None,
            skip: list[str] | None = None) -> CompareResult:
    """Gate candidate snapshots against baseline snapshots.

    ``threshold`` is the noise floor every metric gets for free; ``k``
    scales the per-metric CV so noisy metrics earn a wider gate.  ``only``
    / ``skip`` are glob-or-substring patterns over dotted paths (CI skips
    wall-clock ``timing`` sections, gating only deterministic metrics).
    """
    base = metric_stats(base_snapshots)
    cand = metric_stats(cand_snapshots)
    only, skip = list(only or ()), list(skip or ())
    res = CompareResult()
    res.only_base = sorted(p for p in base if p not in cand
                           and _selected(p, only, skip))
    res.only_cand = sorted(p for p in cand if p not in base
                           and _selected(p, only, skip))
    for path in sorted(set(base) & set(cand)):
        if not _selected(path, only, skip):
            continue
        b, c = base[path], cand[path]
        denom = max(abs(b.mean), 1e-9)
        delta = (c.mean - b.mean) / denom
        gate = max(threshold, k * max(b.cv, c.cv))
        dirn = direction(path)
        if dirn == "info":
            verdict = "info"
        else:
            bad = -delta if dirn == "higher" else delta
            if bad > gate:
                verdict = "regressed"
            elif bad < -gate:
                verdict = "improved"
            else:
                verdict = "ok"
        res.deltas.append(MetricDelta(
            path=path, direction=dirn, base=b, cand=c,
            delta=delta, gate=gate, verdict=verdict))
    return res


def format_report(res: CompareResult, *, verbose: bool = False) -> str:
    lines = []
    for d in res.regressions:
        lines.append(
            f"REGRESSED  {d.path}: {d.base.mean:.6g} -> {d.cand.mean:.6g} "
            f"({d.delta:+.1%}, gate ±{d.gate:.1%}, "
            f"cv {max(d.base.cv, d.cand.cv):.1%}, n={d.base.n}/{d.cand.n})")
    for d in res.improvements:
        lines.append(
            f"improved   {d.path}: {d.base.mean:.6g} -> {d.cand.mean:.6g} "
            f"({d.delta:+.1%})")
    if verbose:
        for d in res.deltas:
            if d.verdict in ("ok", "info"):
                lines.append(
                    f"{d.verdict:<10} {d.path}: {d.base.mean:.6g} -> "
                    f"{d.cand.mean:.6g} ({d.delta:+.1%})")
    for p in res.only_base:
        lines.append(f"missing    {p} (baseline only)")
    for p in res.only_cand:
        lines.append(f"new        {p} (candidate only)")
    ok = len([d for d in res.deltas if d.verdict == "ok"])
    lines.append(
        f"{'PASS' if res.passed else 'FAIL'}: {len(res.deltas)} metrics "
        f"compared, {ok} within gate, {len(res.improvements)} improved, "
        f"{len(res.regressions)} regressed")
    return "\n".join(lines)


__all__ = ["compare", "direction", "CompareResult", "MetricDelta",
           "format_report"]
