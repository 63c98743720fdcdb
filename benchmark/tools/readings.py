"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/tools/readings.py --workload <name> --seeds S1,S2,...
        [--control-seeds C1,C2,...] [--seconds 3]

In one process on the card: for each seed, the cell's driver runs a short
window of the cell's own requests (``--seconds``) and checks them as a
run does (the program's readings); for each control seed, the check with
the reference's control in the program's place, over as many requests as
the program's first window answered (the control's readings). One JSON
line a reading; the benchmark's runs never run this. ``--fault`` plants
one of ``mcbench.faults`` under the timed path for the program's
readings.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from mcbench import core, faults, spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="",
                    help="plant this fault (mcbench.faults) under the timed "
                         "path for the program's readings")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    mod = spec.driver(traffic["driver"])
    if args.fault:
        for module, name, fn in faults.plant(traffic["driver"], args.fault):
            setattr(module, name, fn)
    device = torch.device("cuda", 0)
    answered = None
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        d = mod.Driver(config, traffic, device, s)
        if i == 0:
            d.warmup()
        lat, _, _, failed, window_s, _ = core.window(d, args.seconds, False)
        answered = answered or d.n_answered
        d.release()
        t0 = time.perf_counter()
        checks = d.check()
        kind = f"fault:{args.fault}" if args.fault else "program"
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": s,
                          "requests": d.n_answered, "failed": failed,
                          "check_s": time.perf_counter() - t0,
                          **{c[0]: c[1] for c in checks}}), flush=True)
    for s in (int(x) for x in args.control_seeds.split(",") if x):
        d = mod.Driver(config, traffic, device, s)
        d.n_answered = answered
        t0 = time.perf_counter()
        checks = d.check(control=True)
        print(json.dumps({"cell": cell["name"], "kind": "control", "seed": s,
                          "requests": answered,
                          "check_s": time.perf_counter() - t0,
                          **{c[0]: c[1] for c in checks}}), flush=True)


if __name__ == "__main__":
    main()
