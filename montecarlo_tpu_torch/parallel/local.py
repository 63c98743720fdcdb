"""A world of ranks on one machine: ``spawn(fn, world, backend, device,
*args)`` starts ``world`` processes, joins them into one process group
(``backend`` over a ``FileStore`` in a temporary directory: no network),
runs ``fn(mesh, *args)`` on each rank's ``parallel/mesh.Mesh`` and returns
the results in rank order.

The processes start by ``spawn``: each imports ``fn``'s module afresh, so
``fn`` must be a module-level function of a module that is cheap to
import (one that imports no JAX, in a process that has it). Everything
sent to a rank and back is pickled. A rank that raises makes ``spawn``
raise.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from montecarlo_tpu_torch.device import cuda_device
from montecarlo_tpu_torch.parallel.mesh import make_mesh


def _rank_main(rank, fn, world, backend, device, store, out, args):
    torch.set_num_threads(1)  # the ranks share the machine's cores
    if device is None:
        device = torch.device("cuda", rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = fn(make_mesh(device), *args)
        torch.save(result, os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device, *args):
    """``[fn(mesh, *args) on rank r for r in range(world)]``, each rank in
    a process of its own with one intra-op thread, on ``device``
    (``cuda:{rank}`` when None, which needs a card a rank; a device
    named, every rank on it: ``"cpu"``, or ``"cuda:0"`` for ranks sharing
    one card, which NCCL refuses and gloo serves)."""
    if device is None:
        cuda_device()
    with tempfile.TemporaryDirectory(prefix="mc_world_") as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(fn, world, backend, device, os.path.join(tmp, "store"),
                       tmp, args))
        return [torch.load(os.path.join(tmp, f"{rank}.pt"),
                           weights_only=False) for rank in range(world)]
