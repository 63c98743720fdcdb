"""Scale-out over ``torch.distributed``: the port of
``montecarlo_tpu/parallel``.

The JAX package places rollout batches per device with
``jax.sharding.Mesh`` + ``shard_map`` and reduces per-shard statistics with
``psum`` over ICI. The port runs one rank per process in a process group
(NCCL on the card, gloo on the CPU): each rank keeps its shard of tables
or rollouts on its device, and counters, sums and gradients reduce with
``all_reduce``. Every helper takes a 1-D mesh of any size, a world of one
included (``mesh.py``); ``train_dp.py`` is data-parallel REINFORCE;
``local.py`` starts a world of processes on one machine.
"""

from montecarlo_tpu_torch.parallel.mesh import (  # noqa: F401
    equity_sweep,
    make_mesh,
    sharded_equity_vs_hand,
    sharded_selfplay,
)
