"""Philox4x32-10 in plain PyTorch: the counterpart of ``csrc/philox.cuh``.

The random kernels (K1, K2, K4) draw their u32 words from Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11).
This module computes the same words with int64 tensor arithmetic, so the
plain versions can be fed exactly the words a kernel draws: a kernel's
Philox mode and its plain version then compute the same function of
``seed``, on the CPU or on the card.

A stream is keyed by (seed, stream_lo) with the counter words
(block, stream_hi, sub, 0); word i of a stream is output i % 4 of block
i // 4. Words are int64 in [0, 2^32), as everywhere in the plain versions.

The sub-streams taken, with stream_lo (and stream_hi) their index:
- 0: K1's rollouts (the rollout) and K4/K6's tables (the table);
- 1: ``cuda_engine.first_deal`` and the card's ``first_state`` (the table);
- 2: ``cuda_net.deal_stash`` (the table, stream_hi the hand);
- h + 1 for hand h < 65535: K2's rollouts of hand h (the rollout);
- 65536: B3's rollouts (``cuda_equity.MULTIWAY_SUB``);
- 65537: the stage probe's tables (``cuda_stages.SUB_PROBE``);
- 65538: ``rollout/equity.sample_distinct``, the boards of
  ``equity_vs_range`` and of ``models/pushfold.matchup_equity_matrix``
  (the rollout; ``equity.DISTINCT_SUB``);
- 65539: ``equity_vs_range``'s villain draws (the rollout;
  ``equity.RANGE_SUB``);
- 65540: the table engine's decks (the table, stream_hi the hand;
  ``engine/state.DECK_SUB``);
- k << 16 for the policies' streams (the table, stream_hi the step):
  ``rollout/policy.SUB_HANDS``, ``SUB_PERPETUAL``, ``SUB_TOURNAMENT``
  and ``SUB_BOT`` (the server's house bots), ``models/train.SUB_TRAIN``,
  each with its policies' 1 + j above it;
- 65541: ``models/train.fold_seed`` (the data);
- ``parallel/mesh.SUB_MESH_HAND`` (0x3E5A << 16) and
  ``SUB_MESH_SWEEP`` + h (0x3E5B << 16, hero h): the sharded plain
  equity rollouts, keyed (seed, the row of the chunk) with the counter
  words (block, chunk, sub, rank), the one place the fourth counter
  word is not 0.

``philox_blocks`` runs the bare block function: plain for CPU tensors, the
``mc_philox_blocks`` kernel for CUDA tensors (a probe that holds the card's
Philox against published known-answer vectors).
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.ops import _build

I32 = torch.int32
I64 = torch.int64
MASK = 0xFFFFFFFF

# Philox4x32 multipliers and Weyl key increments (Random123).
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def words_as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> their u32 bit patterns as int32."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(I32)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m, for int64 ``a`` in [0, 2^32) and a
    32-bit constant ``m``: split ``m`` in 16-bit halves so that no product
    leaves int64."""
    p1 = a * (m >> 16)
    p0 = a * (m & 0xFFFF)
    mid = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (mid >> 32), mid & MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors (or ints) that broadcast together.

    ``ctr``: four counter words; ``key``: two key words, each in
    [0, 2^32). Returns the four output words, int64 in [0, 2^32)."""
    x0, x1, x2, x3 = ctr
    k0, k1 = key
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(x0, M0)
        hi1, lo1 = _mulhilo(x2, M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + W0) & MASK
        k1 = (k1 + W1) & MASK
    return x0, x1, x2, x3


def stream_words(seed: int, stream_lo, stream_hi, sub, start: int, n: int):
    """Words ``start .. start + n - 1`` of the streams (seed, stream_lo,
    stream_hi, sub), stacked on a new leading axis: int64 [n, *shape].

    ``stream_lo`` is an int64 tensor of stream ids in [0, 2^32);
    ``stream_hi`` and ``sub`` are ints or int64 tensors broadcasting
    against it."""
    lo = torch.as_tensor(stream_lo, dtype=I64)
    hi = torch.as_tensor(stream_hi, dtype=I64, device=lo.device)
    sb = torch.as_tensor(sub, dtype=I64, device=lo.device)
    lo, hi, sb = torch.broadcast_tensors(lo, hi, sb)
    zero = torch.zeros_like(lo)
    words = []
    for block in range(start // 4, (start + n - 1) // 4 + 1):
        words.extend(philox4x32_10((zero + block, hi, sb, zero),
                                   (int(seed) & MASK, lo)))
    first = start % 4
    return torch.stack(words[first:first + n])


LAUNCHES = {"philox_blocks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def philox_blocks(ctr_key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of each row of ``ctr_key``, int64 [n, 6] (four counter
    words, then two key words, each in [0, 2^32)): int64 [n, 4].

    The plain version for a CPU tensor; the ``mc_philox_blocks`` kernel
    (the card's ``csrc/philox.cuh``) for a CUDA tensor."""
    if ctr_key.dim() != 2 or ctr_key.shape[1] != 6:
        raise ValueError(f"ctr_key must be [n, 6], got {tuple(ctr_key.shape)}")
    dev = ctr_key.device
    if dev.type == "cuda":
        n = ctr_key.shape[0]
        inp = words_as_i32(ctr_key).contiguous()
        out = torch.empty((n, 4), dtype=I32, device=dev)
        _build.check(_build.library().mc_philox_blocks(
            inp.data_ptr(), out.data_ptr(), n, _build.stream_ptr(dev)),
            "mc_philox_blocks")
        LAUNCHES["philox_blocks"] += 1
        return out.to(I64) & MASK
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    c = ctr_key.to(I64)
    return torch.stack(philox4x32_10(c[:, :4].unbind(1), c[:, 4:].unbind(1)),
                       dim=1)
