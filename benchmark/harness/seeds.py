"""Seeds of a run: every draw of a cell comes from `--seed` through a
named sub-seed, so the same seed gives the same inputs and weights."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draws named `tag` of the run seeded `seed`
    (any whole number, negative or above 32 bits included)."""
    ss = np.random.SeedSequence(entropy=int(seed) % (1 << 64),
                                spawn_key=(zlib.crc32(tag.encode()),))
    lo, hi = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & ((1 << 63) - 1)


def numpy_rng(seed: int, tag: str) -> np.random.RandomState:
    return np.random.RandomState(sub_seed(seed, tag) % (1 << 32))
