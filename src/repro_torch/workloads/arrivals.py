"""Composable arrival processes: seeded rate shapes over discrete epochs.

The paper's premise is *dynamism* — load is skewed, bursty, and cyclic —
so scenario traces are built from rate processes composed like
expressions and then sampled into integer per-epoch arrival counts with a
seeded Poisson draw::

    rate = diurnal(mean=40, amplitude=0.8, period=48) + flash_crowd(
        at=30, magnitude=200, width=4)
    counts = [sample_poisson(rng, rate(e)) for e in range(96)]

Every process is deterministic given its constructor arguments; the only
randomness is the seeded sampling step (and the seeded state path an
:class:`mmpp` precomputes at construction).  Nothing in this module may
read wall clocks or unseeded RNG: an unseeded draw here silently breaks
trace replay.
"""
from __future__ import annotations

import math
import random


class Arrival:
    """A rate process: ``rate(epoch) -> expected arrivals`` (pkts/epoch).

    Compose with ``+`` (superposition), ``*`` (scalar scale or modulation
    by another process), and :func:`clip`."""

    def rate(self, epoch: int) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, epoch: int) -> float:
        return max(0.0, float(self.rate(epoch)))

    def __add__(self, other: "Arrival | float") -> "Arrival":
        return _Sum(self, _as_arrival(other))

    __radd__ = __add__

    def __mul__(self, other: "Arrival | float") -> "Arrival":
        return _Product(self, _as_arrival(other))

    __rmul__ = __mul__


def _as_arrival(x) -> "Arrival":
    return x if isinstance(x, Arrival) else constant(float(x))


class _Sum(Arrival):
    def __init__(self, a: Arrival, b: Arrival):
        self.a, self.b = a, b

    def rate(self, epoch: int) -> float:
        return self.a(epoch) + self.b(epoch)


class _Product(Arrival):
    def __init__(self, a: Arrival, b: Arrival):
        self.a, self.b = a, b

    def rate(self, epoch: int) -> float:
        return self.a(epoch) * self.b(epoch)


class constant(Arrival):
    """Flat ``value`` pkts/epoch."""

    def __init__(self, value: float):
        self.value = float(value)

    def rate(self, epoch: int) -> float:
        return self.value


class diurnal(Arrival):
    """A day/night cycle: ``mean * (1 + amplitude * sin(...))`` with the
    peak at ``phase`` epochs into each ``period``.  ``amplitude`` in
    [0, 1]: 0 = flat, 1 = troughs touch zero (Figs 2-3's point — per-
    endpoint peaks are much higher than the aggregate's)."""

    def __init__(self, mean: float, amplitude: float = 0.6,
                 period: int = 48, phase: int = 0):
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError("diurnal amplitude must be in [0, 1]")
        if period < 2:
            raise ValueError("diurnal period must be >= 2 epochs")
        self.mean = float(mean)
        self.amplitude = float(amplitude)
        self.period = int(period)
        self.phase = int(phase)

    def rate(self, epoch: int) -> float:
        ang = 2.0 * math.pi * (epoch - self.phase) / self.period
        return self.mean * (1.0 + self.amplitude * math.cos(ang))


class flash_crowd(Arrival):
    """A sudden spike: zero until ``at``, then ``magnitude`` decaying
    exponentially with half-life ``width`` epochs — the shape of a viral
    object or a failover herd landing on one tenant."""

    def __init__(self, at: int, magnitude: float, width: float = 3.0):
        if width <= 0:
            raise ValueError("flash_crowd width must be > 0")
        self.at = int(at)
        self.magnitude = float(magnitude)
        self.width = float(width)

    def rate(self, epoch: int) -> float:
        if epoch < self.at:
            return 0.0
        return self.magnitude * 0.5 ** ((epoch - self.at) / self.width)


class onoff(Arrival):
    """Square-wave burst: ``rate_on`` for ``on`` epochs, 0 for ``off``."""

    def __init__(self, rate_on: float, on: int, off: int, phase: int = 0):
        if on < 1 or off < 0:
            raise ValueError("onoff needs on >= 1 and off >= 0")
        self.rate_on = float(rate_on)
        self.on, self.off, self.phase = int(on), int(off), int(phase)

    def rate(self, epoch: int) -> float:
        return self.rate_on if (epoch - self.phase) % (self.on + self.off) \
            < self.on else 0.0


class mmpp(Arrival):
    """Markov-modulated Poisson process: the rate jumps between ``rates``
    states, dwelling geometrically (mean ``dwell`` epochs) in each.  The
    state path is precomputed for ``horizon`` epochs from ``seed`` at
    construction, so the process is a pure function of epoch afterwards —
    replaying the same trace never re-rolls the chain."""

    def __init__(self, rates: list[float], dwell: float, horizon: int,
                 seed: int = 0):
        if len(rates) < 2:
            raise ValueError("mmpp needs >= 2 rate states")
        if dwell < 1.0:
            raise ValueError("mmpp dwell must be >= 1 epoch")
        self.rates = [float(r) for r in rates]
        rng = random.Random(seed)
        p_leave = 1.0 / float(dwell)
        state = 0
        path = []
        for _ in range(int(horizon)):
            path.append(state)
            if rng.random() < p_leave:
                # jump to a uniformly-drawn *other* state
                step = rng.randrange(1, len(self.rates))
                state = (state + step) % len(self.rates)
        self.path = path

    def rate(self, epoch: int) -> float:
        if not self.path:
            return self.rates[0]
        return self.rates[self.path[min(epoch, len(self.path) - 1)]]


def clip(process: Arrival, lo: float = 0.0,
         hi: float = math.inf) -> Arrival:
    """Clamp a composed process into [lo, hi] pkts/epoch."""
    class _Clip(Arrival):
        def rate(self, epoch: int) -> float:
            return min(max(process(epoch), lo), hi)
    return _Clip()


def sample_poisson(rng: random.Random, lam: float) -> int:
    """Seeded Poisson draw (Knuth for small rates, normal approximation
    above — exactness does not matter, determinism does)."""
    if lam <= 0.0:
        return 0
    if lam < 30.0:
        limit = math.exp(-lam)
        n, p = 0, rng.random()
        while p > limit:
            n += 1
            p *= rng.random()
        return n
    return max(0, int(round(rng.gauss(lam, math.sqrt(lam)))))


__all__ = ["Arrival", "constant", "diurnal", "flash_crowd", "onoff",
           "mmpp", "clip", "sample_poisson"]
