"""BENCH_trajectory.json: the append-only cross-commit perf ledger.

Every gated bench run appends one entry — commit, bench name, the flat
metric means, and the compare verdict against the checked-in snapshot —
so the repo accumulates an actual trajectory instead of a single
mutable number.  The ledger is plain JSON (``{"entries": [...]}``), the
newest entry last; CI uploads it as an artifact and ``perfbench
bisect`` reads the same metric paths it records.
"""
from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

from .metrics import metric_stats


def current_commit() -> str:
    """Best-effort commit id: CI env var first, then git, else 'unknown'."""
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha[:12]
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except OSError:
        pass
    return "unknown"


def load_trajectory(path: str | Path) -> dict:
    path = Path(path)
    if path.exists():
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and isinstance(data.get("entries"), list):
            return data
    return {"entries": []}


def append_entry(path: str | Path, *, bench: str, snapshot: dict,
                 verdict: dict | None = None, commit: str | None = None,
                 label: str | None = None, keep: int = 200) -> dict:
    """Append one ledger entry and rewrite the file.  ``snapshot`` is the
    bench result being recorded (its flat metric means are stored, not
    the raw blob); ``verdict`` is an optional ``CompareResult.to_dict()``.
    The ledger is bounded to the newest ``keep`` entries."""
    ledger = load_trajectory(path)
    stats = metric_stats([snapshot])
    entry = {
        "commit": commit if commit is not None else current_commit(),
        "bench": bench,
        "metrics": {p: round(s.mean, 6) for p, s in stats.items()},
    }
    if label:
        entry["label"] = label
    if verdict is not None:
        entry["verdict"] = verdict
    ledger["entries"].append(entry)
    ledger["entries"] = ledger["entries"][-keep:]
    with open(path, "w") as f:
        json.dump(ledger, f, indent=1, sort_keys=True)
        f.write("\n")
    return entry


__all__ = ["current_commit", "load_trajectory", "append_entry"]
