"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: no device
means ``cuda:0``, and where no GPU is present that is an error, never a
quiet fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without a GPU); an int -> that CUDA
    ordinal; a string or ``torch.device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", 0)
    if isinstance(device, int):
        return torch.device("cuda", device)
    return torch.device(device)
