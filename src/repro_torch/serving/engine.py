"""Multi-tenant LLM serving engine driven by the SuperNIC policy core.

Mapping of the paper's mechanisms onto the serving runtime:

  paper                         | engine
  ------------------------------+------------------------------------------
  packet                        | request (prompt -> generated tokens)
  NT chain                      | ingress -> cache-NT -> prefill -> decode
  per-NT credits                | decode slots (continuous batching)
  FPGA partial reconfiguration  | a step function for a new batch shape
  victim cache of bitstreams    | the per-(kind, bs) step-function table
  pre-launch                    | kernel build + one run of expected shapes
  monitored-demand DRF          | per-epoch token-budget admission control
  NT auto-scaling               | growing/shrinking the decode batch shape
  paged virtual memory (vmem)   | KV slot/page accounting + host swap-out

All multi-tenant policy — per-tenant request queues, epoch DRF over the
(tokens, pages) resource vector, WDRR admission order, the work-conserving
fallback — lives in the shared :class:`repro_torch.core.sched.FairScheduler`;
the engine keeps only the serving mechanism (step functions, KV paging,
model steps).

The port runs eagerly (there is no jit): :meth:`Engine._get_fn` keeps the
JAX package's per-(kind, bs) table and ``compile_log``, and on the card its
first entry carries the build of the CUDA kernels.  The engine runs on
``cuda:0`` unless given ``device="cpu"``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import _device
from repro_torch.analysis import invariants as _sanitize
from repro_torch.core.policy import StepScaler
from repro_torch.core.sched import FairScheduler, SchedConfig, SpaceShare
from repro_torch.core.vmem import OutOfMemory, VirtualMemory
from repro_torch.faults import Overloaded
from repro_torch.kernels import _build
from repro_torch.models import model as MD


@dataclass
class Request:
    rid: int
    tenant: str
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    t_submit: float = 0.0
    t_first: float | None = None     # first-token time
    t_done: float | None = None
    out: list = field(default_factory=list)
    cached: bool = False

    @property
    def latency(self) -> float:
        return (self.t_done or 0.0) - self.t_submit


@dataclass
class EngineConfig:
    max_len: int = 128
    batch_sizes: tuple = (1, 2, 4, 8)   # decode batch shapes (regions)
    page_tokens: int = 16               # KV page granularity (vmem)
    mem_pages: int = 64                 # physical KV pages on "board"
    epoch_requests: int = 8             # DRF epoch, measured in admissions
    cache_entries: int = 64             # response-cache NT capacity (FIFO)
    enable_cache_nt: bool = True
    scale_up_backlog: float = 2.0       # backlog/capacity ratio to scale out
    scale_down_idle: float = 0.25
    #: admission ceiling on *pending* requests; beyond it submit() raises
    #: :class:`repro_torch.faults.Overloaded` with a retry-after hint instead
    #: of letting the backlog grow without bound and stall every tenant
    #: (None = accept everything)
    max_pending: int | None = None


class ResponseCacheNT:
    """The paper's caching NT (§6.1): FIFO keyed by prompt bytes."""

    def __init__(self, entries: int):
        self.entries = entries
        self.data: OrderedDict[bytes, list] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, prompt: np.ndarray):
        key = prompt.tobytes()
        if key in self.data:
            self.hits += 1
            return list(self.data[key])
        self.misses += 1
        return None

    def put(self, prompt: np.ndarray, out: list):
        key = prompt.tobytes()
        if key not in self.data and len(self.data) >= self.entries:
            self.data.popitem(last=False)            # FIFO (paper's choice)
        self.data[key] = list(out)


class Engine:
    def __init__(self, cfg, ecfg: EngineConfig, params=None, seed: int = 0,
                 tenant_weights: dict | None = None, device=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = _device.resolve(device)
        self.params = params if params is not None else MD.init_params(
            seed, cfg, self.device)
        # --- vmem: KV pages (slot -> pages); over-subscription swaps to host
        self.vmem = VirtualMemory(ecfg.mem_pages * (2 << 20))
        self.vmem.page_bytes = 2 << 20
        # --- decode "regions": a step function per batch shape (PR analogue)
        self._decode_fns: dict[int, object] = {}
        self._prefill_fns: dict[int, object] = {}
        self.compile_log: list[tuple[str, int, float]] = []
        self.active_bs = min(ecfg.batch_sizes)
        # --- request plumbing: the shared fair scheduler owns the queues
        # (cost = request tokens; costs vector = {tokens, pages} for DRF).
        # strict=False: submit() auto-registers unknown tenants at weight 1.
        # quantum=1 token: finest-grain WDRR, so equal-weight tenants
        # interleave per *request* inside one admission window
        self.sched = FairScheduler(
            tenant_weights, SchedConfig(quantum=1.0, strict=False),
            clock=time.time)
        self.scaler = StepScaler(ecfg.batch_sizes,
                                 scale_up_ratio=ecfg.scale_up_backlog,
                                 scale_down_ratio=ecfg.scale_down_idle)
        self.done: list[Request] = []
        self.cache_nt = ResponseCacheNT(ecfg.cache_entries)
        self.rid = 0
        #: submissions rejected by the max_pending overload gate
        self.rejected = 0

    # -------------------------------------------------------- step table --
    def _get_fn(self, kind: str, bs: int):
        store = self._decode_fns if kind == "decode" else self._prefill_fns
        if bs not in store:                       # "PR": set up a region
            t0 = time.time()
            if self.device.type == "cuda":
                _build.build_all()                # nvcc on the first use
            if kind == "decode":
                def fn(p, c, b, t):
                    return MD.apply_decode(p, self.cfg, c, b, t)
            else:
                def fn(p, b):
                    return MD.apply_prefill(p, self.cfg, b,
                                            max_len=self.ecfg.max_len)
            store[bs] = fn
            self.compile_log.append((kind, bs, time.time() - t0))
        return store[bs]

    def _tokens(self, rows: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(rows).to(self.device)}

    @torch.inference_mode()
    def prelaunch(self):
        """Paper §4.4 pre-launch: build the kernels and run every expected
        shape once before traffic."""
        dev = self.device
        for bs in self.ecfg.batch_sizes:
            b = self._tokens(np.zeros((bs, 8), np.int32)) \
                if self.cfg.frontend == "tokens" else \
                {"embeds": torch.zeros((bs, 8, self.cfg.d_model), device=dev)}
            self._get_fn("prefill", bs)(self.params, b)
            cache = MD.init_cache(self.cfg, bs, self.ecfg.max_len,
                                  torch.float32, dev)
            step = self._tokens(np.zeros((bs, 1), np.int32)) \
                if self.cfg.frontend == "tokens" else \
                {"embeds": torch.zeros((bs, 1, self.cfg.d_model), device=dev)}
            self._get_fn("decode", bs)(self.params, cache, step, 8)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ tenancy --
    def add_tenant(self, tenant: str, weight: float = 1.0) -> None:
        self.sched.add_tenant(tenant, weight)

    def remove_tenant(self, tenant: str) -> tuple[int, float]:
        """Tenant churn: drop the tenant's queue (pending requests shed)."""
        return self.sched.remove_tenant(tenant)

    @property
    def weights(self) -> dict[str, float]:
        return self.sched.weights

    def _costs(self, req: Request) -> dict[str, float]:
        toks = len(req.prompt) + req.max_new
        pages = (toks + self.ecfg.page_tokens - 1) // self.ecfg.page_tokens
        return {"tokens": float(toks), "pages": float(pages)}

    def retry_after(self) -> float:
        """How long a rejected client should wait before resubmitting: the
        number of admission epochs needed to drain the standing backlog,
        paced at one epoch's worth of requests each."""
        pending = self.sched.pending()
        epochs = max(1.0, pending / max(self.ecfg.epoch_requests, 1))
        return 0.05 * epochs

    # ------------------------------------------------------------ ingress --
    def submit(self, tenant: str, prompt: np.ndarray, max_new: int = 16):
        if self.ecfg.max_pending is not None and \
                self.sched.pending() >= self.ecfg.max_pending:
            self.rejected += 1
            raise Overloaded(self.retry_after(),
                             f"engine over capacity ({self.sched.pending()} "
                             f"pending >= max_pending="
                             f"{self.ecfg.max_pending})")
        self.rid += 1
        req = Request(self.rid, tenant, np.asarray(prompt, np.int32),
                      max_new, t_submit=time.time())
        costs = self._costs(req)
        self.sched.submit(tenant, req, cost=costs["tokens"], costs=costs)
        return req

    # ---------------------------------------------------------------- DRF --
    def _admit(self) -> list[Request]:
        """One admission epoch via the fair scheduler: DRF over the
        (tokens, pages) standing-backlog demand -> per-tenant token
        budgets -> WDRR-ordered admission within budget (work-conserving:
        if budgets admit nothing while work is queued, the head of the
        first tenant in WDRR order is admitted)."""
        caps = {"tokens": float(self.ecfg.epoch_requests * self.ecfg.max_len),
                "pages": float(self.ecfg.mem_pages)}
        res = self.sched.epoch(caps, extra=self.sched.backlog_demand())
        budgets = SpaceShare.budgets(res, "tokens") if res is not None else {}
        admitted = self.sched.admit(budgets,
                                    limit=self.ecfg.epoch_requests)
        return [item.payload for _, item in admitted]

    # ------------------------------------------------------------- engine --
    def _autoscale(self, backlog: int):
        """Instance autoscaling: pick the decode batch shape by load."""
        self.active_bs = self.scaler.decide(self.active_bs, backlog)

    def _alloc_pages(self, req: Request) -> bool:
        n = (len(req.prompt) + req.max_new + self.ecfg.page_tokens - 1) \
            // self.ecfg.page_tokens
        self.vmem.register(f"req{req.rid}")
        try:
            for i in range(n):
                self.vmem.access(f"req{req.rid}", i, time.time())
            return True
        except OutOfMemory:
            # no KV memory for this request right now: roll back and let the
            # caller requeue it
            self.vmem.release(f"req{req.rid}")
            return False

    def step(self):
        """One engine iteration: admit -> cache NT -> prefill -> decode."""
        batch = self._admit()
        # caching NT: hits bypass the model entirely (paper §6.1)
        todo = []
        for r in batch:
            hit = self.cache_nt.get(r.prompt) if self.ecfg.enable_cache_nt \
                else None
            if hit is not None:
                r.out = hit
                r.cached = True
                r.t_first = r.t_done = time.time()
                self.done.append(r)
            elif self._alloc_pages(r):
                todo.append(r)
            else:                                    # no KV memory: requeue
                costs = self._costs(r)
                self.sched.requeue(r.tenant, r, costs["tokens"], costs)
        backlog = self.sched.pending() + len(todo)
        self._autoscale(backlog)

        # prefill + decode in groups of the active batch shape
        for i in range(0, len(todo), self.active_bs):
            group = todo[i:i + self.active_bs]
            self._generate(group)
        if _sanitize.enabled():     # per-iteration conservation audit
            _sanitize.check_engine(self, "engine")
        return len(batch)

    @torch.inference_mode()
    def _generate(self, group: list[Request]):
        if not group:
            return
        bs = self.active_bs
        S = max(len(r.prompt) for r in group)
        prompts = np.zeros((bs, S), np.int32)
        for j, r in enumerate(group):
            prompts[j, S - len(r.prompt):] = r.prompt   # left-pad
        prefill = self._get_fn("prefill", bs)
        decode = self._get_fn("decode", bs)
        # on the card the host runs ahead of the device, so the first token's
        # time comes from two events read after the one sync below (the
        # device is idle when the group starts: the last group ended in it)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if self.device.type == "cuda" else None
        t0 = time.time()
        if marks:
            marks[0].record()
        logits, cache = prefill(self.params, self._tokens(prompts))
        tok = torch.argmax(logits, -1).to(torch.int32)
        if marks:
            marks[1].record()
        t_first = time.time()
        max_new = max(r.max_new for r in group)
        # the decode loop stays on the device: per-step tokens accumulate as
        # device tensors and cross to the host ONCE after the loop
        toks = [tok]
        for step_i in range(max_new - 1):
            logits, cache = decode(self.params, cache,
                                   {"tokens": tok[:, None]}, S + step_i)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks.append(tok)
        steps = torch.stack(toks, dim=1).cpu().numpy()  # (bs, max_new), 1 sync
        if marks:
            t_first = t0 + marks[0].elapsed_time(marks[1]) / 1e3
        for j, r in enumerate(group):
            r.out = [int(t) for t in steps[j, :r.max_new]]
            r.t_first = t_first
            r.t_done = time.time()
            if self.ecfg.enable_cache_nt:
                self.cache_nt.put(r.prompt, r.out)
            self.vmem.release(f"req{r.rid}")
            self.done.append(r)

    def run_until_drained(self, max_iters: int = 1000):
        for _ in range(max_iters):
            if not self.sched.pending():
                break
            self.step()
        return self.done


__all__ = ["Engine", "EngineConfig", "Request", "ResponseCacheNT"]
