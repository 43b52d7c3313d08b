"""TraceDriver: replay one fingerprinted Trace onto any Platform backend.

The driver is the portability layer of the workload plane: the *same*
trace (same fingerprint, same arrival schedule, same churn epochs) drives
the event-driven sim, the fused compute backend in batch or streaming
mode, the LLM serving engine, and a sharded fleet — all through the
public Platform API, never a backend's internals.  What varies per substrate is only how an
"arrival of ``n`` packets for tenant ``t``" materializes (sim events, a
``(n, 5)``/``(n, 16)`` u32 wire batch, or token prompts) and how one trace
epoch maps onto the backend's window (``duration_ns`` for event backends,
one ``run()``/``inject_stream`` window for compute, one drain pass for
serving).

The port's one addition: a fleet whose shards are all compute backends
(``"sharded_compute"``) receives wire batches and one fleet ``run()`` per
epoch, as a single compute backend does; the JAX package's driver sends
every fleet the sim's per-packet injects, which compute shards reject.

Everything synthesized here is keyed on ``(trace.seed, epoch, tenant)``
via sha256 — not ``hash()`` (salted per process) and not unseeded RNG —
so two replays of one trace produce byte-identical injects.  The
``I-TRACE`` invariant (``repro_torch.analysis.invariants``) checks
exactly that under ``REPRO_SANITIZE=1``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from .trace import Trace, TraceTenant


def _derived_seed(seed: int, epoch: int, tenant: str) -> int:
    """Process-stable 64-bit seed for per-(epoch, tenant) synthesis."""
    blob = f"{seed}:{epoch}:{tenant}".encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")


def default_vpc_params(device=None) -> dict:
    """Per-NT kernel params covering every stock VPC chain template, so a
    generated tenant mix deploys on the compute backend unmodified: the
    JAX package's values, as u32 tensors on ``device`` (``None`` is
    ``cuda:0``)."""
    import torch

    from repro_torch.serving.vpc import make_rules
    rules = make_rules(16, seed=2, device=device)
    dev = rules[0].device
    return {
        "firewall": {"rules": rules},
        "nat": {"nat_ip": 0x0A000001},
        "chacha20": {
            "key": (torch.arange(8, device=dev) * 3 + 1).to(torch.uint32),
            "nonce": (torch.arange(3, device=dev) + 7).to(torch.uint32)},
    }


@dataclass
class DriveResult:
    """What one replay observed: identity, schedule, census, counters."""
    backend: str
    trace_fingerprint: str
    #: sha256 over the realized (epoch, tenant, pkts, pkt_bytes) schedule —
    #: must be identical across substrates and across double-runs
    schedule_fingerprint: str = ""
    #: per-epoch sorted live-tenant names
    census: list[list[str]] = field(default_factory=list)
    injected: dict[str, int] = field(default_factory=dict)
    served: dict[str, int] = field(default_factory=dict)
    report: object = None

    def counters(self) -> dict[str, dict[str, int]]:
        """The I-TRACE comparison payload: per-tenant inject/serve counts."""
        return {"injected": dict(sorted(self.injected.items())),
                "served": dict(sorted(self.served.items()))}


class TraceDriver:
    """Plays a :class:`Trace` onto one :class:`~repro_torch.api.Platform`.

    Parameters
    ----------
    platform:
        The platform to drive.  The backend kind (sim / sharded / sharded
        compute / compute batch / compute stream / serve) is sniffed from
        its public surface, never its class.
    params:
        Per-NT deploy params for compute backends (default:
        :func:`default_vpc_params`).  Ignored elsewhere.
    chain_map:
        Optional ``{chain_tuple: chain_tuple}`` remap applied at deploy
        time — e.g. map every VPC chain onto ``("prefill", "decode")`` to
        replay the *same* fingerprinted trace on the serving engine with
        the schedule and census untouched.
    max_new:
        Tokens generated per serving request (serve backends only).
    prompt_len:
        Prompt tokens per serving request.
    """

    def __init__(self, platform, *, params: dict | None = None,
                 chain_map: dict | None = None, max_new: int = 4,
                 prompt_len: int = 5):
        self.platform = platform
        self.params = params
        self.chain_map = dict(chain_map or {})
        self.max_new = int(max_new)
        self.prompt_len = int(prompt_len)

    # ------------------------------------------------------------ sniffing --
    @property
    def kind(self) -> str:
        be = self.platform.backend
        if hasattr(be, "global_epoch_ns"):
            if all(hasattr(s, "inject_stream") for s in be.shards):
                return "sharded_compute"
            return "sharded"
        if hasattr(be, "inject_stream"):
            return "compute_stream" if getattr(be, "stream", False) \
                else "compute"
        if hasattr(be, "add_source"):
            return "sim"
        if hasattr(be, "engine"):
            return "serve"
        raise TypeError(
            f"TraceDriver cannot classify backend {be!r}")

    # ------------------------------------------------------------- replay --
    def drive(self, trace: Trace) -> DriveResult:
        """Replay ``trace`` start-to-finish and return the observation."""
        kind = self.kind
        res = DriveResult(backend=kind,
                          trace_fingerprint=trace.fingerprint())
        deployments: dict[str, object] = {}
        schedule: list[tuple[int, str, int, int]] = []

        # tenants live from epoch 0 join before any traffic
        for t in trace.tenants:
            if t.join_epoch == 0:
                deployments[t.name] = self._join(t)

        for epoch in range(trace.epochs):
            for t in trace.tenants:
                if t.join_epoch == epoch and t.name not in deployments:
                    deployments[t.name] = self._join(t)
            res.census.append(trace.census(epoch))

            batch: list[tuple[TraceTenant, object, int]] = []
            for name, pkts in trace.arrivals(epoch):
                tt = trace.tenant(name)
                if not tt.live_at(epoch) or name not in deployments:
                    continue            # generator bug, not a replay crash
                batch.append((tt, deployments[name], pkts))
                schedule.append((epoch, name, pkts, tt.pkt_bytes))
                res.injected[name] = res.injected.get(name, 0) + pkts
            self._play_epoch(kind, trace, epoch, batch)

            for t in trace.tenants:
                if t.leave_epoch == epoch + 1:
                    self._leave(t.name)
                    deployments.pop(t.name, None)

        self._drain(kind, trace)
        blob = json.dumps(schedule, sort_keys=True, separators=(",", ":"))
        res.schedule_fingerprint = hashlib.sha256(
            blob.encode()).hexdigest()[:16]
        res.report = self.platform.report()
        for name, tr in res.report.tenants.items():
            if tr.pkts_done:
                res.served[name] = int(tr.pkts_done)
        return res

    # ----------------------------------------------------------- lifecycle --
    def _chain(self, t: TraceTenant) -> tuple[str, ...]:
        return tuple(self.chain_map.get(t.chain, t.chain))

    def _join(self, t: TraceTenant):
        from repro_torch.api import nt
        ten = self.platform.tenant(t.name, weight=t.weight)
        chain = self._chain(t)
        expr = nt(chain[0])
        for name in chain[1:]:
            expr = expr >> nt(name)
        kw = {}
        if self.kind in ("compute", "compute_stream", "sharded_compute"):
            kw["params"] = self.params if self.params is not None \
                else default_vpc_params(self._device())
        return ten.deploy(expr, **kw)

    def _device(self):
        """The (first) compute shard's device, where default params go."""
        be = self.platform.backend
        return getattr(be, "shards", [be])[0].device

    def _leave(self, name: str) -> None:
        be = self.platform.backend
        if hasattr(be, "remove_tenant"):
            be.remove_tenant(name)
        self.platform.tenants.pop(name, None)

    # ------------------------------------------------------------- epochs --
    def _play_epoch(self, kind: str, trace: Trace, epoch: int,
                    batch: list) -> None:
        if kind in ("sim", "sharded"):
            for tt, dep, pkts in batch:
                for _ in range(pkts):
                    dep.inject(tt.pkt_bytes)
            self._advance_window(kind, trace)
        elif kind in ("compute", "sharded_compute"):
            for tt, dep, pkts in batch:
                dep.inject(state=self._wire_state(trace, epoch, tt, pkts))
            if batch:
                self.platform.run()
        elif kind == "compute_stream":
            triples = [(tt.name, dep.uid,
                        self._wire_state(trace, epoch, tt, pkts))
                       for tt, dep, pkts in batch]
            if triples:
                self.platform.backend.inject_stream(iter(triples))
        elif kind == "serve":
            for tt, dep, pkts in batch:
                for i in range(pkts):
                    dep.inject(self._prompt(trace, epoch, tt.name, i),
                               max_new=self.max_new)
            if batch:
                self.platform.run()

    def _advance_window(self, kind: str, trace: Trace) -> None:
        be = self.platform.backend
        if kind == "sharded":
            self.platform.run(duration_ns=be.global_epoch_ns)
        else:
            self.platform.run(
                duration_ns=trace.epoch_ns or be.epoch_ns)

    def _drain(self, kind: str, trace: Trace) -> None:
        """Let in-flight work finish so served counters are settled."""
        be = self.platform.backend
        if kind in ("sim", "sharded"):
            # a few extra windows flush queued events, then settle()
            for _ in range(4):
                self._advance_window(kind, trace)
            if hasattr(be, "settle"):
                be.settle()
        elif kind == "serve":
            self.platform.run()

    # ---------------------------------------------------------- synthesis --
    def _wire_state(self, trace: Trace, epoch: int, tt: TraceTenant,
                    pkts: int) -> dict:
        """One wire batch: (n, 5) headers + (n, 16) payload, u32 tensors on
        the host (as packets arrive from one), keyed on (seed, epoch,
        tenant) so replays are byte-identical, and drawn as the JAX
        package draws them."""
        import numpy as np
        import torch
        rng = np.random.default_rng(
            _derived_seed(trace.seed, epoch, tt.name))
        return {
            "headers": torch.from_numpy(rng.integers(
                0, 2 ** 32, size=(pkts, 5), dtype=np.uint32)),
            "payload": torch.from_numpy(rng.integers(
                0, 2 ** 32, size=(pkts, 16), dtype=np.uint32)),
        }

    def _prompt(self, trace: Trace, epoch: int, tenant: str, i: int):
        import numpy as np
        rng = np.random.default_rng(
            _derived_seed(trace.seed, epoch, f"{tenant}#{i}"))
        return rng.integers(1, 32, size=(self.prompt_len,),
                            dtype=np.int32)


__all__ = ["TraceDriver", "DriveResult", "default_vpc_params"]
