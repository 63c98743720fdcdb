"""Device selection: the port runs its kernels on a CUDA card only."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """``torch.device("cuda")``, or raise when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need a GPU")
    return torch.device("cuda")
