"""Shuffling batch iterators over cached activations (counterpart of
``whisper_sae_tpu/data/loader.py:27-105``): the same
``np.random.default_rng(seed)`` permutation stream, a new order each
epoch, and the final partial batch kept unless ``drop_last``.  ``data``
is a numpy array or a CPU tensor (a bf16 cache stays bf16).
:class:`PairedActivationLoader` yields row-aligned ``(x, y)`` pairs, the
transcoder's (mlp_in, mlp_out) layout."""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch


class ActivationLoader:
    """Mini-batches of rows of a ``[num_tokens, dim]`` array or tensor."""

    def __init__(self, data, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.data = data if isinstance(data, torch.Tensor) else np.asarray(data)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    @property
    def num_tokens(self) -> int:
        return int(self.data.shape[0])

    def __len__(self) -> int:
        n = self.num_tokens / self.batch_size
        return math.floor(n) if self.drop_last else math.ceil(n)

    def _batch_indices(self) -> Iterator[np.ndarray]:
        n = self.num_tokens
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            yield order[start:start + self.batch_size]

    def __iter__(self):
        tensor = isinstance(self.data, torch.Tensor)
        for idx in self._batch_indices():
            yield self.data[torch.from_numpy(idx)] if tensor else self.data[idx]


class PairedActivationLoader(ActivationLoader):
    """Mini-batches of row-aligned ``(x, y)`` pairs; ``.data = (x, y)`` so
    the trainer's fused epoch takes both buffers."""

    def __init__(self, x, y, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        super().__init__(x, batch_size, shuffle, seed, drop_last)
        y = y if isinstance(y, torch.Tensor) else np.asarray(y)
        if self.data.shape[0] != y.shape[0]:
            raise ValueError(
                f"paired arrays must be row-aligned (got {self.data.shape[0]} vs {y.shape[0]})")
        self.data = (self.data, y)

    @property
    def num_tokens(self) -> int:
        return int(self.data[0].shape[0])

    def __iter__(self):
        x, y = self.data
        tensor = isinstance(x, torch.Tensor)
        for idx in self._batch_indices():
            idx = np.sort(idx)
            if tensor:
                idx = torch.from_numpy(idx)
            yield x[idx], y[idx]
