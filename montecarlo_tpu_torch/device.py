"""Device selection: the port runs its kernels on a CUDA card only."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """``torch.device("cuda")``, or raise when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need a GPU")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """The device of an entry point: the card when ``device`` is None (raise
    when none is visible), else ``device`` (``"cpu"`` runs the plain
    versions)."""
    return cuda_device() if device is None else torch.device(device)
