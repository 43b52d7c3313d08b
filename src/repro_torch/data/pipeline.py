"""Data pipeline: deterministic synthetic LM batches with host-side
prefetch and sequence packing.

An infinite, step-indexed stream (resumable from any step after a
checkpoint restore: the step number *is* the data state).  Each batch is
drawn with numpy from ``(seed, step)`` exactly as the JAX package draws it,
so both packages see the same tokens; ``batch(step)`` hands it to the
device from pinned host memory without blocking.  ``place`` gives each rank
of a mesh its own chunk of a batch by the batch specs (every rank draws
the same batch, so no data moves between ranks).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import _device


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class SyntheticLM:
    """Deterministic synthetic next-token-prediction data.

    Tokens are drawn from a per-step generator keyed by (seed, step);
    labels are tokens shifted by one (causal LM).  Markov-ish structure
    (mixing a shifted copy) gives the loss a learnable signal.  ``device``
    defaults to ``cuda:0``.
    """

    def __init__(self, cfg, B: int, S: int, seed: int = 0, device=None):
        self.cfg, self.B, self.S, self.seed = cfg, B, S, seed
        self.device = _device.resolve(device)

    def host_batch(self, step: int) -> dict:
        """The batch of ``step`` as numpy arrays."""
        rng = np.random.default_rng((self.seed, step))
        V = self.cfg.vocab_size
        B, S = self.B, self.S
        if self.cfg.frontend == "tokens":
            base = rng.integers(0, V, (B, S + 1), dtype=np.int32)
            # learnable structure: token_{t+1} correlates with token_t
            repeat = rng.random((B, S + 1)) < 0.5
            base[:, 1:] = np.where(repeat[:, 1:],
                                   (base[:, :-1] * 31 + 7) % V,
                                   base[:, 1:])
            return {"tokens": np.ascontiguousarray(base[:, :-1]),
                    "labels": np.ascontiguousarray(base[:, 1:])}
        emb = rng.standard_normal((B, S, self.cfg.d_model),
                                  dtype=np.float32) * 0.02
        labels = rng.integers(0, V, (B, S), dtype=np.int32)
        return {"embeds": emb, "labels": labels}

    def batch(self, step: int) -> dict:
        return {k: _to_device(v, self.device)
                for k, v in self.host_batch(step).items()}

    def stream(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def place(batch: dict, mesh, specs) -> dict:
    """Each rank's leaves of ``batch`` (tensors or numpy arrays) by
    ``specs`` (``parallel.sharding.batch_specs``): plain tensors, the
    rank's chunk, on the mesh's device."""
    from repro_torch.parallel.sharding import distribute, local

    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    placed = distribute(tensors, {k: specs[k] for k in tensors}, mesh)
    return {k: local(v).contiguous() for k, v in placed.items()}


class _Axes:
    """The mesh seen through some of its axes (a rule-table mesh)."""

    def __init__(self, shape: dict):
        self.shape, self.axis_names = shape, tuple(shape)


def place_microbatches(batch: dict, accum: int, mesh,
                       all_axes: bool = False) -> list:
    """``batch`` split into ``accum`` microbatches as the JAX package splits
    the global batch (rows ``[i B / accum, (i + 1) B / accum)``), each
    placed by ``batch_specs``: a list of each rank's leaves.  Two rules of
    the port's own, where the rows do not divide over the batch ranks
    (where the JAX package's ``fit_spec`` replicates the batch):
      - the batch is split into the most microbatches, up to ``accum``,
        whose rows divide over the batch ranks, else placed whole
        (``grad_accum`` bounds the rows a rank holds at once; the 2 x 16 x
        16 mesh's grok-1 step takes 8 microbatches of 32 rows, one a rank);
      - a batch that does not divide over every batch axis is split over
        the minor ones that it divides and repeated over the rest (the
        2 x 16 x 16 mesh's 256-row batch: over "data" x "model", once per
        pod)."""
    from repro_torch.parallel.sharding import P, batch_specs, data_axes, view

    m = view(mesh)
    axes = m.axis_names if all_axes else data_axes(mesh)
    size = lambda ax: int(np.prod([m.shape[a] for a in ax]))  # noqa: E731
    B = next(iter(batch.values())).shape[0]
    accum = next((a for a in range(accum, 1, -1)
                  if B % a == 0 and (B // a) % size(axes) == 0), 1)
    rows = B // accum
    while axes and rows % size(axes):
        axes = axes[1:]                     # repeat over the major axis
    sub = _Axes({a: m.shape[a] for a in axes})
    micro = [batch] if accum <= 1 else [
        {k: v.reshape(accum, rows, *v.shape[1:])[i]
         for k, v in batch.items()} for i in range(accum)]
    out = []
    for mb in micro:
        specs = batch_specs(mb, sub, all_axes=True) if axes else \
            {k: P() for k in mb}
        out.append(place(mb, mesh, specs))
    return out


def pack_documents(docs: list[np.ndarray], S: int, pad_id: int = 0,
                   eos_id: int = 1) -> np.ndarray:
    """Greedy sequence packing: concatenate docs with EOS separators into
    S-token rows (standard pretraining packing)."""
    rows, cur = [], []
    used = 0
    for d in docs:
        d = list(d) + [eos_id]
        while d:
            take = min(len(d), S - used)
            cur.extend(d[:take])
            d = d[take:]
            used += take
            if used == S:
                rows.append(cur)
                cur, used = [], 0
    if cur:
        rows.append(cur + [pad_id] * (S - used))
    return np.asarray(rows, np.int32)


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


__all__ = ["Prefetcher", "SyntheticLM", "pack_documents", "place",
           "place_microbatches"]
