"""The benchmark's one traffic generator, driven by a traffic file.

A training mix (``"kind": "train"``) gives the batch rows and their
length, and how many first steps the reference follows
(``reference_steps``); each step's rows are uniform token ids drawn on
the device from ``--seed`` and the step's index, every row different.
"""
from __future__ import annotations

import torch

from .weights import derive


def train_batch(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s (tokens, labels), each (rows, seq): a row of
    ``seq + 1`` ids and its shift by one."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(
        derive(seed, f"batch.{step}"))
    ids = torch.randint(0, vocab, (mix["rows"], mix["seq"] + 1),
                        generator=gen, device=device, dtype=torch.int64)
    return (ids[:, :-1].to(torch.int32).contiguous(),
            ids[:, 1:].to(torch.int32).contiguous())


__all__ = ["train_batch"]
