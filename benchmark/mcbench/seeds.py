"""Everything random in a run comes from ``--seed`` through these.

``--seed`` may be any whole number, wider than 32 bits or negative; it is
taken modulo 2^64. Streams are numpy ``SeedSequence``s keyed by the seed
and a purpose, so request i's inputs depend on (seed, i) alone and a
check's sample on (seed, "check").
"""

from __future__ import annotations

import zlib

import numpy as np


def _entropy(seed: int, *keys) -> list:
    out = [int(seed) % (1 << 64)]
    for k in keys:
        out.append(zlib.crc32(k.encode()) if isinstance(k, str) else int(k))
    return out


def rng(seed: int, *keys) -> np.random.Generator:
    """A numpy generator for (seed, *keys); keys are ints >= 0 or str."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(_entropy(seed, *keys))))


def kernel_seed(seed: int, *keys) -> int:
    """A seed for the program's calls, in [0, 2^31)."""
    state = np.random.SeedSequence(_entropy(seed, *keys)).generate_state(1)
    return int(state[0]) & 0x7FFFFFFF
