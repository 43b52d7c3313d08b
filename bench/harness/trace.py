"""The device trace of a ``--trace 1`` window, and the harness's spans.

The window runs under ``torch.profiler`` with CUDA activity alone (no host
op is recorded, so the host pays nothing per operation).  From the trace:
the union of the intervals in which a kernel, copy or fill ran (busy
seconds), each kernel name's summed time, and the idle gaps, each put to
the span the host was in at the gap's middle.  Spans are kept in memory
by the harness around its calls into the program (``grad``, ``compress``,
``adamw``); host time outside them is ``host``.  A spin kernel launched at the window's start, after a
synchronisation, ties the trace's clock to the host's.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

MARK_CYCLES = 20_000


class Spans:
    """Named host intervals in ``time.time_ns()``."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t, time.time_ns()))

    def at(self, t_ns: float) -> str:
        """The innermost span holding ``t_ns`` (the latest started)."""
        best = None
        for name, a, b in self.items:
            if a <= t_ns <= b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "host"


class DeviceTrace:
    """``torch.profiler`` over a window; :meth:`read` after it closes."""

    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.mark_ns = 0

    def __enter__(self):
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_ns = time.time_ns()
        torch.cuda._sleep(MARK_CYCLES)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list[tuple[str, int, int]]:
        """(name, start ns, end ns) of every device event."""
        out = []
        res = self.prof.profiler.kineto_results
        for e in res.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                a, dur = e.start_ns(), e.duration_ns()
            else:
                a, dur = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), a, a + dur))
        return out

    def read(self, t0_ns: int, t1_ns: int, spans: Spans) -> dict:
        evs = sorted(self.events(), key=lambda e: e[1])
        marks = [e for e in evs if "spin" in e[0].lower()]
        offset = (marks[0][1] - self.mark_ns) if marks else 0
        evs = [(n, a - offset, b - offset) for n, a, b in evs
               if "spin" not in n.lower()]
        kernel_s: dict[str, float] = {}
        for n, a, b in evs:
            kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) / 1e9
        busy, gaps, cur = 0, {}, t0_ns
        for _, a, b in evs:
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b <= a:
                continue
            if a > cur:
                name = spans.at((a + cur) / 2)
                gaps[name] = gaps.get(name, 0.0) + (a - cur) / 1e9
                cur = a
            if b > cur:
                busy += b - cur
                cur = b
        if t1_ns > cur:
            name = spans.at((t1_ns + cur) / 2)
            gaps[name] = gaps.get(name, 0.0) + (t1_ns - cur) / 1e9
        return {"busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
                "kernel_s": kernel_s, "idle_gaps": gaps,
                "events": len(evs), "clock_offset_ns": offset,
                "marked": bool(marks)}


class MoeCounter:
    """Wraps the experts' dispatch (``repro_torch.models.moe.
    _group_dispatch``, which the experts layer looks up at each call) and
    keeps, per call, the entries kept and the experts given any, as
    device scalars read after the window."""

    def __init__(self, hf: dict):
        from repro_torch.models import moe as MOE
        from .weights import DTYPES
        self.mod, self.orig = MOE, MOE._group_dispatch
        self.calls: list[tuple] = []
        self.f = hf["intermediate_size"]
        self.w_bytes = DTYPES[hf["param_dtype"]].itemsize
        orig = self.orig

        def dispatch(x, gates, idx, E, C, before=None, stride=None):
            out = orig(x, gates, idx, E, C, before, stride)
            _, slot, keep, _, _ = out
            expert = torch.where(keep, slot // (stride or C),
                                 torch.full_like(slot, E)).reshape(-1)
            used = torch.zeros(E + 1, dtype=torch.int64, device=x.device)
            used.scatter_add_(0, expert, torch.ones_like(expert))
            self.calls.append((keep.sum(), (used[:E] > 0).sum(),
                               x.shape[-1]))
            return out

        MOE._group_dispatch = dispatch

    def remove(self):
        self.mod._group_dispatch = self.orig

    def read(self) -> dict:
        return {"calls": [(int(k), int(u), d) for k, u, d in self.calls],
                "f": self.f, "w_bytes": self.w_bytes}


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


__all__ = ["DeviceTrace", "MoeCounter", "Spans", "breakdown"]
