"""montecarlo_tpu_torch — the Monte Carlo Hold'em engine in PyTorch + CUDA.

The port of ``montecarlo_tpu`` to an NVIDIA Hopper card. The JAX package is
the reference; this package mirrors its module names where that helps a
reader find the counterpart:

- ``cards.py``, ``handval.py``, ``actions.py``  the card, hand-value and
                          action encodings (copies of the framework-free
                          JAX-package modules; a test holds every public
                          name equal);
- ``device.py``           the card by default, the CPU when asked;
- ``ops/evaluator.py``    the bitmask 7-card evaluator on int32 tensors;
- ``ops/philox.py``       Philox4x32-10 in plain PyTorch (the kernels'
                          words; ``csrc/philox.cuh`` on the card);
- ``ops/cuda_equity.py``  equity rollouts, multiway equity and the
                          169-hand sweep (kernels in ``csrc/equity.cu``,
                          ``csrc/multiway.cu``);
- ``ops/cuda_engine.py``  the whole-step betting engine over the packed
                          per-table state, reference, standard and
                          tournament rules, and tournaments run to
                          completion (kernels in ``csrc/engine.cu``);
- ``ops/cuda_net.py``     policy-net evaluation inside the engine, with
                          banks and populations (kernels in
                          ``csrc/net.cu``);
- ``ops/cuda_carry.py``, ``ops/cuda_stages.py``  the carry probe and the
                          engine-stage probe (``csrc/probe_carry.cu``,
                          ``csrc/probe_stages.cu``);
- ``ops/_build.py``       nvcc build of ``csrc/`` and the ctypes binding;
- ``models/features.py``, ``models/policy_net.py``  the 24 decision
                          features and the 24-64-64-4 policy MLP;
- ``models/bots.py``      rule bots as packed nets;
- ``models/train_es.py``  evolution-strategies training on the kernels;
- ``models/pushfold.py``  the heads-up push/fold Nash solver and its
                          matchup equity matrices;
- ``rollout/equity.py``   the user-facing equity API: hand vs hand,
                          random or range, multiway, exact enumeration of
                          hands and ranges;
- ``engine/``             the table engine in plain PyTorch, tables on a
                          leading axis (the JAX engine is XLA):
                          ``bets.py`` the layer algebra (the default
                          street form), ``street.py`` the levels street
                          form and the dispatch, ``state.py``
                          ``TableConfig``, ``TableState``, Philox decks
                          and hand setup, ``step.py`` ``step_action`` and
                          ``step_table``, ``public.py`` the host JSON view,
                          ``replay.py`` the engine on K3's injected stream
                          and its agreement with K3;
- ``native.py``           the ctypes loader of ``native/mcpoker.cpp``
                          (the C++ single-table engine and evaluators),
                          built with g++ into ``_build/native/``;
- ``server/``             the TCP/JSON poker server: ``host.py`` rooms and
                          the registry, ``backends.py`` ``NativeBackend``
                          and ``TorchBackend`` (one table of ``engine/``),
                          ``tcp.py`` the asyncio transport; ``python -m
                          montecarlo_tpu_torch`` serves it;
- ``utils/``              table-state checkpoints and ``torch.profiler``
                          traces, the equity CI meter at a wall clock;
- ``parallel/``           scale-out over ``torch.distributed``: tables and
                          rollouts sharded over ranks, counters and
                          gradients ``all_reduce``d (``mesh.py``,
                          ``train_dp.py``), N ranks on one machine
                          (``local.py``);
- ``scripts/``            ports of the repository's scripts
                          (``exp_carry_model``, ``debug_kernel_compile``,
                          ``build_pushfold_cr``) and the kernels' A/B
                          (``ab_engine``).

Every kernel has a plain PyTorch version of the same function beside it.
A wrapper runs the plain version only for tensors that lie on the CPU; for
a CUDA tensor it launches the kernel or raises. The entry points run on
the card unless the caller passes ``device="cpu"`` (``device.resolve``).
The package imports nothing of ``jax`` and nothing of ``montecarlo_tpu``.
"""

__version__ = "0.1.0"
