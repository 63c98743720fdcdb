"""Sharded rollouts over ``torch.distributed``: the port of
``montecarlo_tpu/parallel/mesh.py``.

The JAX module lays a 1-D "tables" mesh over every device and runs each
entry under ``shard_map``: each device keeps its rollouts' state, and only
the win/tie counters cross devices, by ``psum``. Here the mesh is a
process group with one rank per process. Each rank holds its shard of
tables or rollouts on its own device, and only counters, sums and (in
``parallel/train_dp.py``) gradients cross ranks, by ``all_reduce``; no
table state is gathered. An output sharded over tables stays on its rank
as the rank's tables; a reduction comes back equal on every rank.

JAX discovers its mesh at run time, so one chip is a mesh of one. So it
is here: ``make_mesh()`` takes the default process group where one is
initialized, starts it from ``torchrun``'s environment where that is set,
and otherwise starts a world of one, so that a world of one rank is the
normal single-card case and not a fallback. ``parallel/local.spawn`` starts an
N-rank world of processes on one machine (the tests, the smoke's two
ranks on one card).

Random words. JAX folds the device's axis index into the key
(``fold_in(key, axis_index)``) and then the chunk (``fold_in(key, i)``).
The port's entries name the rank and the chunk the same way, each its own
way per route:
- the plain rollouts (``sharded_equity_vs_hand``, ``equity_sweep``):
  row b of chunk i on rank r draws Philox4x32-10 keyed (seed, b) at the
  counter words (block, i, sub, r), with sub ``SUB_MESH_HAND``, or
  ``SUB_MESH_SWEEP`` + h for hero h (``ops/philox.py`` lists them): no
  two ranks, chunks, rows or heroes share a stream;
- the kernels take a seed per rank, as the JAX module computes it:
  K1 ``seed + 0x9E3779 r`` (mod 2^32), K4 ``(seed + 7919 r) &
  0x7FFFFFFF``;
- the plain engine's tables go by their global index (rank r holds
  tables r T .. (r + 1) T - 1): a table deals and draws the same at any
  table count and on any rank, where JAX splits one key over all W T
  tables. Rank r's shard equals those rows of the unsharded call.

The card's ranks reduce over NCCL. A gloo group reduces CUDA tensors
through host copies (``all_reduce``): the two-rank world on one card is
gloo, since NCCL refuses two ranks on one GPU, and what crosses is a few
counters or one gradient vector.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import torch
import torch.distributed as dist

from montecarlo_tpu_torch.device import cuda_device
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops.evaluator import suit_masks_from_cards
from montecarlo_tpu_torch.ops.philox import MASK, philox4x32_10
from montecarlo_tpu_torch.rollout.equity import EquityResult
from montecarlo_tpu_torch.rollout.selfplay import (
    play_hands,
    play_hands_perpetual,
    play_tournament,
)

I32 = torch.int32
I64 = torch.int64
AXIS = "tables"

# Philox sub-streams of the plain sharded rollouts (ops/philox.py).
SUB_MESH_HAND = 0x3E5A << 16
SUB_MESH_SWEEP = 0x3E5B << 16
# The per-rank seed strides of the kernel entries (JAX mesh.py:184, :296).
K1_RANK_STRIDE = 0x9E3779
K4_RANK_STRIDE = 7919


class Mesh(NamedTuple):
    """A 1-D mesh of ranks: the process group, this process's rank, the
    world size, the rank's device and the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def make_mesh(device=None) -> Mesh:
    """The mesh of every rank of the default process group, on
    ``device``: ``cuda:{LOCAL_RANK}`` when None (raise without a card),
    ``"cpu"`` for the CPU.

    Without a default group it starts one on the device's backend (NCCL
    for the card, gloo for the CPU): from ``torchrun``'s environment
    (``init_method="env://"``) where ``WORLD_SIZE`` is set, else a world
    of one through a ``FileStore`` in a temporary directory (no network).
    A failed start raises."""
    if device is None:
        cuda_device()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            path = os.path.join(tempfile.mkdtemp(prefix="mc_mesh_"), "store")
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    rank=0, world_size=1)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                dev, dist.get_backend())


def all_reduce(mesh: Mesh, x: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ranks, in place, and returned. A gloo group
    reduces a CUDA tensor through a host copy."""
    if mesh.backend == "gloo" and x.device.type == "cuda":
        host = x.cpu()
        dist.all_reduce(host, op, group=mesh.group)
        return x.copy_(host)
    dist.all_reduce(x, op, group=mesh.group)
    return x


def broadcast(mesh: Mesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` as rank ``src`` holds it, on every rank, in place."""
    if mesh.backend == "gloo" and x.device.type == "cuda":
        host = x.cpu()
        dist.broadcast(host, src, group=mesh.group)
        return x.copy_(host)
    dist.broadcast(x, src, group=mesh.group)
    return x


def all_gather(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (of one shape), concatenated along ``dim`` in
    rank order."""
    host = mesh.backend == "gloo" and x.device.type == "cuda"
    y = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y, group=mesh.group)
    return torch.cat(parts, dim).to(x.device)


def _mesh_words(seed: int, rank: int, chunk: int, sub, k: int, n: int,
                device) -> torch.Tensor:
    """Words 0 .. k - 1 of rows 0 .. n - 1 of chunk ``chunk`` on rank
    ``rank``: int64 [k, *sub.shape, n] (``sub`` an int or an int64 [H]
    tensor), Philox keyed (seed, row) at the counter words (block,
    chunk, sub, rank)."""
    if not (0 <= rank <= MASK and 0 <= chunk <= MASK and n <= MASK + 1):
        raise ValueError(f"rank {rank}, chunk {chunk} or {n} rows past "
                         f"a 32-bit counter word")
    row = torch.arange(n, dtype=I64, device=device)
    sub = torch.as_tensor(sub, dtype=I64, device=device)[..., None]
    zero = torch.zeros_like(sub + row)
    words = []
    for block in range((k + 3) // 4):
        words.extend(philox4x32_10(
            (zero + block, zero + chunk, zero + sub, zero + rank),
            (int(seed) & MASK, zero + row)))
    return torch.stack(words[:k])


def _batching(mesh: Mesh, n_rollouts: int, per_device_batch: int):
    """(batch, chunks) of a rank, as the JAX module computes them
    (``mesh.py:71-72``): every rank runs ``chunks`` chunks of ``batch``
    rollouts, so n = batch x chunks x W >= ``n_rollouts``."""
    batch = min(per_device_batch, max(1, n_rollouts // mesh.size))
    return batch, -(-n_rollouts // (batch * mesh.size))


def _result(counts, n) -> EquityResult:
    w, t = (int(x) for x in counts.tolist())
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


def sharded_equity_vs_hand(mesh: Mesh, seed: int, hero, villain,
                           n_rollouts: int,
                           per_device_batch: int = 1 << 19) -> EquityResult:
    """Hand-vs-hand equity with the rollouts sharded over the ranks and the
    int64 win/tie counters ``all_reduce``d (BASELINE config 5's
    machinery). Plain PyTorch on the rank's device: each chunk draws 5
    distinct board cards a rollout from the 48 live cards
    (``cuda_equity._distinct_slots``, ``sample_distinct``'s ordered
    draws), maps them past the dead cards (``slots_to_cards``) and ranks
    both hands (``ops/evaluator``). n = batch x chunks x W, as JAX's."""
    dev = mesh.device
    batch, n_chunks = _batching(mesh, n_rollouts, per_device_batch)
    dead, hm, vm = cq._hand_masks(hero, villain, (), dev)
    dead = [int(d) for d in dead.tolist()]
    counts = torch.zeros(2, dtype=I64, device=dev)
    for i in range(n_chunks):
        words = _mesh_words(seed, mesh.rank, i, SUB_MESH_HAND, 5, batch, dev)
        counts += cq._equity_counts_plain(words, dead, hm.tolist(),
                                          vm.tolist())
    return _result(all_reduce(mesh, counts), batch * n_chunks * mesh.size)


def equity_sweep(mesh: Mesh, seed: int, heroes, n_rollouts_per_hand: int,
                 per_device_batch: int = 1 << 14):
    """Equity vs a random villain for a batch of hero hands ([H, 2], e.g.
    the 169 canonical starting hands): every rank rolls its share for
    *all* hands (villain and board: 7 distinct cards off the hero's, the
    first two the villain's), and the [2, H] win/tie counters are
    ``all_reduce``d. Plain PyTorch (K2's plain version on the mesh's
    words). Returns (equity float64 numpy [H], n_per_hand)."""
    dev = mesh.device
    heroes = torch.as_tensor(heroes, dtype=I32).reshape(-1, 2)
    H = heroes.shape[0]
    dead = torch.sort(heroes, dim=1).values.to(dev)
    hm = torch.stack(suit_masks_from_cards(heroes), dim=1).to(dev)
    subs = SUB_MESH_SWEEP + torch.arange(H, dtype=I64)
    batch, n_chunks = _batching(mesh, n_rollouts_per_hand, per_device_batch)
    counts = torch.zeros((2, H), dtype=I64, device=dev)
    for i in range(n_chunks):
        words = _mesh_words(seed, mesh.rank, i, subs, 7, batch, dev)
        counts += cq._sweep_counts_plain(words, dead, hm)
    all_reduce(mesh, counts)
    n = batch * n_chunks * mesh.size
    w, t = counts.cpu().double().numpy()
    return (w + 0.5 * t) / n, n


def sharded_equity_pallas(mesh: Mesh, seed: int, hero, villain,
                          n_rollouts: int, board=()) -> EquityResult:
    """The equity kernel K1 on the mesh: rank r launches K1 with seed
    (``seed`` + 0x9E3779 r) mod 2^32 over its share, ceil(n / W)
    rollouts (K1 takes any count), and the two counters are
    ``all_reduce``d. On one rank it is the single K1 call
    (``cuda_equity.equity_vs_hand_kernel``); on the CPU K1's plain
    version."""
    per_rank = -(-n_rollouts // mesh.size)
    dead, hm, vm = cq._hand_masks(hero, villain, board, mesh.device)
    counts = cq.equity_counts((seed + K1_RANK_STRIDE * mesh.rank) & MASK,
                              dead, hm, vm, per_rank)
    return _result(all_reduce(mesh, counts), per_rank * mesh.size)


def _hands(mesh: Mesh, hand_idx: torch.Tensor) -> int:
    total = hand_idx.sum(dtype=I64).reshape(1)
    return int(all_reduce(mesh, total))


def sharded_selfplay(mesh: Mesh, seed: int, cfg: TableConfig,
                     tables_per_device: int = 1 << 12, num_hands: int = 1):
    """Random-policy self-play (``rollout/selfplay.play_hands``) with the
    tables sharded over the ranks (BASELINE config 4 at scale): rank r
    plays tables r T .. (r + 1) T - 1 of the seed and returns their final
    states."""
    T = tables_per_device
    return play_hands(seed, cfg, T, num_hands, device=mesh.device,
                      first_table=mesh.rank * T)


def sharded_selfplay_perpetual(mesh: Mesh, seed: int, cfg: TableConfig,
                               tables_per_device: int = 1 << 12,
                               n_steps: int = 64):
    """Perpetual tables (``play_hands_perpetual``) sharded over the ranks:
    ``(the rank's final states, hands completed on every rank)``, the
    hand count ``all_reduce``d."""
    T = tables_per_device
    final, _ = play_hands_perpetual(seed, cfg, T, n_steps,
                                    device=mesh.device,
                                    first_table=mesh.rank * T)
    return final, _hands(mesh, final.hand_idx)


def sharded_tournaments(mesh: Mesh, seed: int, cfg: TableConfig,
                        tables_per_device: int = 1 << 10,
                        max_hands: int = 64):
    """Tournaments (``play_tournament``) sharded over the ranks: the
    rank's ``(final, busted_at, seat_stacks)``."""
    T = tables_per_device
    return play_tournament(seed, cfg, T, max_hands, device=mesh.device,
                           first_table=mesh.rank * T)


def _hand_count(mesh: Mesh, state, cfg: TableConfig) -> int:
    return _hands(mesh, ce.unpack_field(state, cfg, "hand_ct"))


def sharded_selfplay_kernel(mesh: Mesh, seed: int, cfg: TableConfig,
                            blocks_per_device: int = 64,
                            n_steps: int = 256):
    """The engine kernel K4 on the mesh: rank r's first state is tables
    r T .. (r + 1) T - 1 of ``cuda_engine.first_state(seed, cfg, W T)``
    (``first_table`` r T), and it runs ONE launch of ``n_steps`` slots with
    seed (``seed`` + 7919 r) & 0x7FFFFFFF; the completed-hand counter is
    ``all_reduce``d. On one rank it is ``selfplay_perpetual_kernel``'s
    single launch. Returns (the rank's final packed state, total
    hands)."""
    T = blocks_per_device * ce.TABLES_PER_BLOCK
    P = cfg.num_seats
    first = ce.first_state(seed, cfg, T, mesh.device, mesh.rank * T)
    out = ce.run_perpetual_prng(
        (seed + K4_RANK_STRIDE * mesh.rank) & 0x7FFFFFFF, first, P,
        n_steps, cfg.small_blind, cfg.big_blind, rules=cfg.rules)
    return out, _hand_count(mesh, out, cfg)


def _on(mesh: Mesh, x) -> torch.Tensor:
    return torch.as_tensor(x).to(mesh.device, I32)


def sharded_selfplay_kernel_det(mesh: Mesh, cfg: TableConfig, state,
                                actions, cards, n_steps: int):
    """The deterministic engine kernel K3 on the mesh: each rank passes its
    own blocks (``state`` [B, F, 8, 128]), their injected actions [B,
    n_steps, 8, 128] and deal stashes [B, hmax, 2P+5, 8, 128], i.e. rows
    r B .. (r + 1) B - 1 of the global arrays; the completed-hand counter
    is ``all_reduce``d. Returns (the rank's final state, total hands)."""
    out = ce.run_perpetual_det(_on(mesh, state), _on(mesh, actions),
                               _on(mesh, cards), cfg.num_seats, n_steps,
                               cfg.small_blind, cfg.big_blind,
                               rules=cfg.rules)
    return out, _hand_count(mesh, out, cfg)


def sharded_net_kernel_det(mesh: Mesh, cfg: TableConfig, state, cards,
                           weights: torch.Tensor, n_steps: int,
                           seat_to_bank=None):
    """The deterministic net kernel K5 on the mesh: each rank passes its
    own blocks and deal stashes (as ``sharded_selfplay_kernel_det``); the
    packed weights (``cuda_net.net_weights`` or ``bank_weights``, banks
    mapped to seats by ``seat_to_bank``) are broadcast from rank 0, so
    every rank plays rank 0's nets; the completed-hand counter is
    ``all_reduce``d. Returns (the rank's final state, total hands)."""
    w = broadcast(mesh, weights.to(mesh.device).clone())
    out = cn.run_net_det(_on(mesh, state), _on(mesh, cards), w,
                         cfg.num_seats, n_steps, cfg.small_blind,
                         cfg.big_blind, cfg.rules, seat_to_bank)
    return out, _hand_count(mesh, out, cfg)
