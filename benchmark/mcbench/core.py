"""One run of one cell: set-up, warm-up, the measured window, the check.

``run(argv)`` is the whole of ``benchmark/run.py``:

1. It refuses to run (exit 2, no result) without a CUDA card, with fewer
   cards than the cell asks for, or without the port's package.
2. Set-up: the cell's configuration, traffic and driver are found by name
   (``spec``); the driver loads what its requests need and runs one
   warm-up request of the cell's own shapes, which builds or loads every
   kernel library the window uses. ``setup_s`` runs from the start of the
   process (the first line of ``run.py``) to the first timed request.
3. The window: one client in a closed loop sends requests 0, 1, 2, ...
   until ``--seconds`` have passed; the last request started in time is
   waited for, and the window's time runs to its end. Each request's
   latency runs from the call until its result is on the host. With
   ``--trace 1`` the window runs inside ``torch.profiler``.
4. After the window: the device's peak memory is read; the driver frees
   the program's state and checks the answers against the plain
   reference (``mcref``).
5. The metrics: each of the cell's end-to-end metrics (``--trace 0``) or
   per-layer metrics (``--trace 1``) by its reader, ``metrics/<name>.py``.
   A reader that finds nothing to read returns None and the metric is
   left out. The last line of standard output is the result, whose last
   key ``checks`` holds each number compared beside its limit; the same
   numbers are the last lines of standard error. Just before the result
   is printed, no module of ``jax``, ``jaxlib``, ``flax`` or the JAX
   package may be loaded: otherwise the run exits 3 with no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

from mcbench import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlo_tpu")
PROGRAM = "montecarlo_tpu_torch"


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    latencies_s: list
    totals: dict        # the work of the window, counted from the answers
    main_kernel: str    # the cell's main kernel, a part of its name
    summary: object = None  # trace.Summary of a traced run


@dataclasses.dataclass
class Check:
    """One number compared with its limit; it passes at or below it."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def add_work(totals: dict, work: dict) -> None:
    for k, v in work.items():
        totals[k] = totals.get(k, 0) + v


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def window(driver, seconds: float, traced: bool):
    """The closed loop: (latencies, totals, attempted, failed, window
    seconds, trace summary)."""
    latencies, totals = [], {}
    attempted = failed = 0
    with trace.traced(traced, driver.span) as holder:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            t_req = time.perf_counter()
            try:
                work = driver.request(attempted - 1)
            except Exception:       # a request that fails ends the run
                traceback.print_exc()
                failed += 1
                break
            latencies.append(time.perf_counter() - t_req)
            add_work(totals, work)
        t1 = time.perf_counter()
    return latencies, totals, attempted, failed, t1 - t0, holder.summary


def device_info(device, chips: int, peak: int) -> dict:
    """The result's ``device``; a CPU run (the tests) says so."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def run(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
             f"{cell['chips']}")
    try:
        __import__(PROGRAM)
    except ImportError as e:
        fail(f"the program ({PROGRAM}) is not here: {e}")
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    mod = spec.driver(traffic["driver"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return measure(bench, cell, config, traffic, mod, device, args, t_start)


def measure(bench, cell, config, traffic, mod, device, args,
            t_start: float) -> int:
    """Steps 2 to 5 on ``device`` (the card, or the CPU in the tests)."""
    import torch
    on_card = device.type == "cuda"
    driver = mod.Driver(config, traffic, device, args.seed)
    driver.warmup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    latencies, totals, attempted, failed, window_s, summary = window(
        driver, args.seconds, bool(args.trace))
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()
    t_check = time.perf_counter()
    try:
        checks = [Check(*c) for c in driver.check()]
    except Exception:
        traceback.print_exc()
        checks = [Check("check_raised", 1.0, 0.0)]
    t_check_s = time.perf_counter() - t_check
    add_work(totals, driver.extra_work())
    ctx = Context(config, traffic, setup_s, window_s,
                  latencies, totals, mod.MAIN_KERNEL, summary)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], kind):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, cell["chips"], peak)
    result = {"correct": failed == 0 and all(c.ok for c in checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.union_s()
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(10),
                               "idle_gaps": summary.idle_gaps(10)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(f"requests {len(latencies)} in {window_s:.3f} s; work "
          f"{json.dumps(totals)}; check {t_check_s:.3f} s; after the "
          f"window {time.perf_counter() - t_end:.3f} s", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    # last, so that what the check and the readers load is seen too
    found = forbidden_modules()
    if found:
        fail(f"modules loaded that the benchmark may not load: {found}", 3)
    print(json.dumps(result), flush=True)
    return 0
