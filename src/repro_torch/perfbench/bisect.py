"""Threshold-based perf bisection over a commit range.

``bisect_first_bad`` is the pure algorithm: given commits ordered
oldest-to-newest where the first is known good and the last known bad,
binary-search the first commit whose probe fails.  The probe for the
CLI re-runs a named smoke bench inside a throwaway ``git worktree`` of
the candidate commit and gates it against the baseline snapshot with
the same variance-aware compare the CI job uses — so "bad" means "the
gate that failed on HEAD also fails here", not an eyeballed number.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable


def bisect_first_bad(commits: list[str],
                     probe: Callable[[str], bool],
                     *, assume_endpoints: bool = True) -> tuple[str, int]:
    """Return ``(first_bad_commit, probes_used)``.

    ``commits`` is oldest-to-newest; ``probe(commit)`` returns True when
    the commit is good.  With ``assume_endpoints`` (default) the first
    commit is trusted good and the last bad without probing; otherwise
    both endpoints are verified first and a ValueError is raised when
    the range is not actually good-to-bad.
    """
    if len(commits) < 2:
        raise ValueError("bisect needs >= 2 commits (good..bad)")
    probes = 0
    if not assume_endpoints:
        probes += 2
        if not probe(commits[0]):
            raise ValueError(f"first commit {commits[0]} is already bad")
        if probe(commits[-1]):
            raise ValueError(f"last commit {commits[-1]} is still good")
    lo, hi = 0, len(commits) - 1          # lo known good, hi known bad
    while hi - lo > 1:
        mid = (lo + hi) // 2
        probes += 1
        if probe(commits[mid]):
            lo = mid
        else:
            hi = mid
    return commits[hi], probes


def list_commits(rev_range: str, repo: str | Path = ".") -> list[str]:
    """Oldest-to-newest commit ids for ``good..bad`` (inclusive of both
    endpoints)."""
    if ".." not in rev_range:
        raise ValueError(f"expected a good..bad range, got {rev_range!r}")
    good = rev_range.split("..")[0]
    out = subprocess.run(
        ["git", "rev-list", "--reverse", rev_range],
        capture_output=True, text=True, cwd=str(repo), check=True)
    commits = [c for c in out.stdout.split() if c]
    base = subprocess.run(
        ["git", "rev-parse", good], capture_output=True, text=True,
        cwd=str(repo), check=True).stdout.strip()
    return [base] + commits


def make_bench_probe(bench: str, baseline_path: str | Path, *,
                     threshold: float = 0.10, k: float = 3.0,
                     repeats: int = 1,
                     only: list[str] | None = None,
                     skip: list[str] | None = None,
                     repo: str | Path = ".",
                     runner: Callable[[str, str], dict] | None = None,
                     log: Callable[[str], None] = print
                     ) -> Callable[[str], bool]:
    """Build a probe that checks one commit out into a temp worktree,
    runs ``bench`` there in smoke mode (via ``python -m
    repro_torch.perfbench run``), and returns the variance-gated verdict
    vs ``baseline_path``.

    ``runner(commit, workdir) -> snapshot_dict`` can be injected (tests
    use a fake); the default shells out to the worktree's own perfbench.
    """
    from .compare import compare
    from .metrics import load_snapshot
    baseline = load_snapshot(baseline_path)
    repo = Path(repo)

    def default_runner(commit: str, workdir: str) -> dict:
        out = Path(workdir) / "snapshot.json"
        subprocess.run(
            [sys.executable, "-m", "repro_torch.perfbench", "run", bench,
             "--repeats", str(repeats), "--out", str(out)],
            cwd=workdir, check=True,
            env={**__import__("os").environ,
                 "PYTHONPATH": str(Path(workdir) / "src")})
        return load_snapshot(out)

    run = runner if runner is not None else default_runner

    def probe(commit: str) -> bool:
        workdir = tempfile.mkdtemp(prefix=f"perfbisect-{commit[:8]}-")
        try:
            if runner is None:
                subprocess.run(
                    ["git", "worktree", "add", "--detach", workdir, commit],
                    cwd=str(repo), check=True, capture_output=True)
            snap = run(commit, workdir)
            verdict = compare([baseline], [snap], threshold=threshold,
                              k=k, only=only, skip=skip)
            log(f"  {commit[:12]}: "
                f"{'good' if verdict.passed else 'BAD '} "
                f"({len(verdict.regressions)} regression(s))")
            return verdict.passed
        finally:
            if runner is None:
                subprocess.run(
                    ["git", "worktree", "remove", "--force", workdir],
                    cwd=str(repo), capture_output=True)
            shutil.rmtree(workdir, ignore_errors=True)

    return probe


def bisect_cli(args, log: Callable[[str], None] = print) -> int:
    """Drive a full bisection; returns a process exit code."""
    commits = list_commits(args.range, repo=args.repo)
    if len(commits) < 2:
        log(f"range {args.range} holds {len(commits)} commit(s); "
            "nothing to bisect")
        return 2
    log(f"bisecting {len(commits)} commits for bench {args.bench!r} "
        f"(~{max(1, (len(commits) - 1).bit_length())} probes)")
    probe = make_bench_probe(
        args.bench, args.baseline, threshold=args.threshold, k=args.k,
        repeats=args.repeats, only=args.only, skip=args.skip,
        repo=args.repo, log=log)
    first_bad, probes = bisect_first_bad(commits, probe)
    log(f"first bad commit: {first_bad} ({probes} probes)")
    print(json.dumps({"first_bad": first_bad, "probes": probes}))
    return 0


__all__ = ["bisect_first_bad", "list_commits", "make_bench_probe",
           "bisect_cli"]
