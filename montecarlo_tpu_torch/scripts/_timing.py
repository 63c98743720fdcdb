"""Best-of-n timing of a call, on the card with CUDA events; the peak
device memory of a run."""

from __future__ import annotations

import json
import sys
import time

import torch


def best_ms(fn, device: torch.device, reps: int = 3):
    """(output of a first, untimed call of ``fn``, best time in ms of
    ``reps`` more calls). On the card each call is timed with CUDA events;
    on the CPU (the plain versions) with the host clock."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return out, min(times)


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu (plain versions)"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain versions)"


def log_peak_memory(device: torch.device, what: str) -> None:
    """On the card, one stderr line with the peak device memory allocated
    so far in this process (GB) and the card's name."""
    if device.type == "cuda":
        print(json.dumps({"peak_device_gb": torch.cuda.max_memory_allocated(
            device) / 1e9, "of": what, "device": device_name(device)}),
            file=sys.stderr, flush=True)
