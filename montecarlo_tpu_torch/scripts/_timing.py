"""Best-of-n timing of a call, on the card with CUDA events."""

from __future__ import annotations

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
