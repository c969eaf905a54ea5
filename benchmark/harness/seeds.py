"""Seeds derived from a run's ``--seed``, one per named purpose, so that
the same seed gives the same weights, rows and mels on every run."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` from the run's seed (any whole number)."""
    state = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(tag.encode())]).generate_state(
        2, np.uint64)
    return int(state[0]) >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded for ``tag``."""
    return torch.Generator(device=device).manual_seed(derive(seed, tag))
