"""One diagnostic record type shared by all three analysis passes.

Every rule — admission verifier, ast linter, invariant harness — reports
the same shape: a stable rule id, a severity, a *subject path* (what the
finding is about: a file:line, a ``dag:<uid>/stage<i>/branch<j>`` path, a
scheduler queue), a message, and a fix hint.  Uniform records mean one
renderer, one JSON schema for the CI artifact, and one baseline mechanism.

Baselines are keyed by ``rule::subject-sans-line`` with *counts*: a rule
already firing N times on a file stays green at <= N and fails the build at
N+1, so pre-existing violations are enumerated (visible in the artifact)
while new ones gate.  Line numbers are stripped from the key so unrelated
edits shifting a file cannot churn the baseline.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field


class Severity:
    """String severities, ordered.  ``ERROR`` rejects a deploy in strict
    mode and fails the lint gate; ``WARNING`` surfaces but never rejects;
    ``INFO`` is advisory."""
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"
    ORDER = (ERROR, WARNING, INFO)

    @staticmethod
    def rank(sev: str) -> int:
        return Severity.ORDER.index(sev) if sev in Severity.ORDER else 99


@dataclass(frozen=True)
class Diagnostic:
    """One finding from any analysis pass."""
    rule: str                 # stable id, e.g. "V-CYCLE", "L-HOSTSYNC"
    severity: str             # Severity.ERROR | WARNING | INFO
    subject: str              # "src/x.py:41" or "dag:3/stage1/branch0"
    message: str
    hint: str = ""            # how to fix it

    def key(self) -> str:
        """Baseline key: rule + subject with any :<line> suffix stripped."""
        subject = re.sub(r":\d+$", "", self.subject)
        return f"{self.rule}::{subject}"

    def __str__(self) -> str:
        s = f"{self.subject}: {self.severity}[{self.rule}] {self.message}"
        return f"{s} (hint: {self.hint})" if self.hint else s


def sort_diags(diags: list[Diagnostic]) -> list[Diagnostic]:
    return sorted(diags, key=lambda d: (Severity.rank(d.severity),
                                        d.subject, d.rule))


def render_text(diags: list[Diagnostic]) -> str:
    """Human-readable report, most severe first."""
    if not diags:
        return "no diagnostics"
    lines = [str(d) for d in sort_diags(diags)]
    counts: dict[str, int] = {}
    for d in diags:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    tally = ", ".join(f"{n} {sev}(s)" for sev, n in sorted(
        counts.items(), key=lambda kv: Severity.rank(kv[0])))
    return "\n".join(lines + [f"-- {tally}"])


def to_json(diags: list[Diagnostic]) -> str:
    return json.dumps([asdict(d) for d in sort_diags(diags)], indent=2)


@dataclass
class Baseline:
    """Checked-in enumeration of pre-existing diagnostics.

    ``counts`` maps :meth:`Diagnostic.key` to the number of occurrences
    that are grandfathered.  :meth:`new` returns only findings *beyond*
    the baseline — the set a CI gate fails on.
    """
    counts: dict[str, int] = field(default_factory=dict)

    @staticmethod
    def load(path) -> "Baseline":
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return Baseline()
        return Baseline(dict(data.get("counts", {})))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"counts": dict(sorted(self.counts.items()))}, f,
                      indent=2, sort_keys=True)
            f.write("\n")

    @staticmethod
    def from_diags(diags: list[Diagnostic]) -> "Baseline":
        b = Baseline()
        for d in diags:
            b.counts[d.key()] = b.counts.get(d.key(), 0) + 1
        return b

    def new(self, diags: list[Diagnostic]) -> list[Diagnostic]:
        """Diagnostics not covered by the baseline: for each key, the
        first ``counts[key]`` occurrences are grandfathered, the rest are
        new."""
        remaining = dict(self.counts)
        out = []
        for d in sort_diags(diags):
            k = d.key()
            if remaining.get(k, 0) > 0:
                remaining[k] -= 1
            else:
                out.append(d)
        return out


__all__ = ["Baseline", "Diagnostic", "Severity", "render_text",
           "sort_diags", "to_json"]
