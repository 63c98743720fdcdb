"""montecarlo_tpu_torch — the Monte Carlo Hold'em engine in PyTorch + CUDA.

The port of ``montecarlo_tpu`` to an NVIDIA Hopper card. The JAX package is
the reference; this package mirrors its module names where that helps a
reader find the counterpart:

- ``ops/evaluator.py``    the bitmask 7-card evaluator on int32 tensors;
- ``ops/cuda_equity.py``  equity rollouts and the 169-hand sweep
                          (kernels in ``csrc/equity.cu``);
- ``ops/cuda_engine.py``  the whole-step betting engine over the packed
                          per-table state (kernels in ``csrc/engine.cu``);
- ``ops/_build.py``       nvcc build of ``csrc/`` and the ctypes binding;
- ``rollout/equity.py``   the user-facing equity API;
- ``engine/state.py``     ``TableConfig``.

Every kernel has a plain PyTorch version of the same function beside it.
A wrapper runs the plain version only for tensors that lie on the CPU; for
a CUDA tensor it launches the kernel or raises. The package never imports
``jax``. The card and hand-value encodings are those of the framework-free
``montecarlo_tpu.cards`` and ``montecarlo_tpu.handval``, re-exported here
as ``cards`` and ``handval`` on first access; the port's own modules use
copies of the few constants they need (tests hold them equal), so running
the port loads nothing of ``montecarlo_tpu``.
"""

import importlib

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("cards", "handval"):
        return importlib.import_module(f"montecarlo_tpu.{name}")
    raise AttributeError(
        f"module 'montecarlo_tpu_torch' has no attribute {name!r}")
