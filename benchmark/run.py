"""Run one cell of the benchmark of ``montecarlo_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout with ``BENCHMARK.json``. Prints the result as
the last line of standard output (``mcbench/core.py`` says what it holds).
Caches of the CUDA driver and of Triton stay inside the checkout, under
``.bench_cache/``; the port builds its kernels under
``montecarlo_tpu_torch/_build/``, also inside it.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def _environment() -> None:
    cache = os.path.join(CHECKOUT, ".bench_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    for p in (HERE, CHECKOUT):
        if p not in sys.path:
            sys.path.insert(0, p)


if __name__ == "__main__":
    _environment()
    from mcbench import core
    sys.exit(core.run(sys.argv[1:], T_START))
