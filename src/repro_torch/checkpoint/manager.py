"""Checkpointing: atomic, async, device-agnostic restore.

The JAX package's contract, on trees of tensors:
  - atomic & durable: writes go to ``step_N.tmp`` (every leaf and the
    meta fsynced, then the directory), an existing ``step_N`` is renamed
    aside to ``step_N.old`` rather than deleted, and only then does
    ``os.replace`` publish the new data: at no instant does the step
    exist solely as a half-written directory.  ``__init__`` sweeps the
    leftovers of a crash (orphan ``.tmp`` dirs are discarded; an orphan
    ``.old`` whose final is missing or torn is promoted back);
  - async: the device->host copy is synchronous (the deliberate sync
    point of a save) but file I/O happens on a background executor so the
    train loop continues;
  - leaves are saved as full values, one ``.npy`` per leaf (bf16 through
    an int16 view, its dtype named in the meta), and restored onto the
    device and dtype of the ``like`` tree's leaf, shape asserted;
  - keep-last-k garbage collection;
  - the data-pipeline state is one integer (the step), stored in meta.json;
  - elastic: a tree of DTensors is saved logically, as full values (each
    leaf gathered, rank 0 writes, ``wait`` ends with a barrier), and
    ``restore`` places each leaf like ``like``'s DTensor leaf, so a restart
    may use another mesh shape (the JAX package's ``shardings`` argument).
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch._tree import leaves, unflatten
from repro_torch.parallel.sharding import is_dtensor, place


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _distributed() else 0


def _host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array of its own (the step updates the tensor in
    place while the write runs) and its dtype's name.  A DTensor is
    gathered to its full value first (every rank takes part)."""
    if is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    name = str(x.dtype).removeprefix("torch.")
    if x.dtype == torch.bfloat16:          # numpy has no bfloat16
        x = x.view(torch.int16)
    return x.numpy(), name


def _fsync_path(path: Path) -> None:
    """fsync one file or directory; directory fsync is what makes a rename
    durable (POSIX), and is a no-op on filesystems that reject it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _complete(d: Path) -> bool:
    """A checkpoint directory is complete iff its meta parses and every
    leaf file it names exists: the torn-file detector for crash-mid-save
    remnants (and for out-of-band truncation)."""
    meta = d / "meta.json"
    try:
        n = int(json.loads(meta.read_text())["n_leaves"])
    except (OSError, ValueError, KeyError):
        return False
    return all((d / f"leaf_{i}.npy").exists() for i in range(n))


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last: Future | None = None
        self._sharded = False
        if _rank() == 0:
            self._recover()
        if _distributed():
            import torch.distributed as dist
            dist.barrier()

    def _recover(self) -> None:
        """Sweep crash leftovers: a ``.tmp`` was never published, drop it;
        a ``.old`` means the crash hit between rename-aside and publish,
        promote it back unless a complete final already exists."""
        for p in list(self.dir.iterdir()):
            if not p.is_dir():
                continue
            if p.name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
            elif p.name.endswith(".old"):
                final = self.dir / p.name[:-len(".old")]
                if final.exists() and _complete(final):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    if final.exists():
                        shutil.rmtree(final, ignore_errors=True)
                    os.replace(p, final)
        _fsync_path(self.dir)

    # ---------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             block: bool = False) -> Future:
        """Snapshot ``tree`` at ``step``.  Device->host happens now; file
        writes happen async (pass block=True to wait)."""
        # the checkpoint boundary IS the device->host copy; one snapshot
        # per save, not a per-step sync
        self._sharded = any(is_dtensor(x) for x in leaves(tree))
        pairs = [_host(x) for x in leaves(tree)]
        if self._sharded and _rank() != 0:     # rank 0 writes the values
            self._last = Future()
            self._last.set_result(step)
            if block:
                self.wait()
            return self._last
        host = [a for a, _ in pairs]
        meta = {"step": step, "n_leaves": len(host),
                "dtypes": [name for _, name in pairs], "extra": extra or {}}

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            old = self.dir / f"step_{step}.old"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, a in enumerate(host):
                p = tmp / f"leaf_{i}.npy"
                np.save(p, a)
                _fsync_path(p)
            mp = tmp / "meta.json"
            mp.write_text(json.dumps(meta))
            _fsync_path(mp)
            _fsync_path(tmp)
            # never delete the published copy before the new one lands:
            # rename it aside, publish, then drop the aside; a crash in
            # any window leaves either the old or the new step recoverable
            if final.exists():
                if old.exists():
                    shutil.rmtree(old)
                os.replace(final, old)
            os.replace(tmp, final)
            _fsync_path(self.dir)
            if old.exists():
                shutil.rmtree(old, ignore_errors=True)
            self._gc()
            return step

        if self._last is not None:
            self._last.result()                      # keep saves ordered
        self._last = self._pool.submit(write)
        if block:
            self.wait()
        return self._last

    def wait(self):
        if self._last is not None:
            self._last.result()
        if self._sharded:               # every rank sees the published step
            import torch.distributed as dist
            dist.barrier()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------- restore --
    def steps(self) -> list[int]:
        """Published, *complete* steps only: a torn directory (crash or
        truncation after publish) is invisible here, so ``latest_step``
        and default restore fall back to the newest good one."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith((".tmp", ".old"))
                      and _complete(p))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None, like: Any) -> tuple[Any, dict]:
        """Load ``step`` (default latest) into the structure of ``like``;
        each leaf lands on the device and dtype of ``like``'s leaf, and
        where that leaf is a DTensor, placed like it (on its mesh, which
        may have another shape than the saving run's)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        if not _complete(d):
            raise FileNotFoundError(
                f"checkpoint step {step} in {self.dir} is torn "
                "(missing leaves or unreadable meta)")
        meta = json.loads((d / "meta.json").read_text())
        refs = leaves(like)
        assert meta["n_leaves"] == len(refs), \
            f"checkpoint has {meta['n_leaves']} leaves, model has {len(refs)}"
        loaded = []
        for i, (ref, dtype) in enumerate(zip(refs, meta["dtypes"])):
            a = np.load(d / f"leaf_{i}.npy")
            assert tuple(a.shape) == tuple(ref.shape), (i, a.shape, ref.shape)
            t = torch.from_numpy(a)
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            if is_dtensor(ref):
                loaded.append(place(t.to(dtype=ref.dtype), ref.device_mesh,
                                    ref.placements))
            else:
                loaded.append(t.to(device=ref.device, dtype=ref.dtype))
        return unflatten(like, loaded), meta["extra"]


__all__ = ["CheckpointManager"]
