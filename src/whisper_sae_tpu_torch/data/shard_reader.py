"""Out-of-core row gather over a cache's ``.npy`` shards, with a prefetch
thread (the port's copy of ``whisper_sae_tpu/runtime/shard_reader.py``).

The gather is the JAX module's numpy-memmap path, the one it takes when
its native ``libwstio`` is not built (``shard_reader.py:160-166``,
``:184-189``); the native reader is not ported yet.  Rows come back as a
CPU tensor of the stored type: bf16 shards (void-2 in their ``.npy``
headers) are read as their 16-bit patterns and viewed as
``torch.bfloat16``, without a third-party dtype package.
"""

from __future__ import annotations

import math
import queue
import threading
from pathlib import Path

import numpy as np
import torch

_BF16 = "bfloat16"


def rows_to_tensor(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    """Gathered stored rows -> a CPU tensor of the metadata dtype."""
    if dtype_name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype_name) if dtype_name else arr.dtype
    return torch.from_numpy(np.ascontiguousarray(arr).view(want))


class ShardReader:
    """Row gather over a set of 2-D ``.npy`` shards forming one ``[N, dim]``
    dataset.  ``dtype`` is the cache metadata's element type (the shards'
    own for bf16 caches is void-2)."""

    def __init__(self, shard_paths: list[Path | str], dtype: str | None = None):
        self.paths = [Path(p) for p in shard_paths]
        self._mmaps = [np.load(p, mmap_mode="r") for p in self.paths]
        first = self._mmaps[0]
        for p, m in zip(self.paths, self._mmaps):
            if m.ndim != 2 or m.shape[1] != first.shape[1] or m.dtype != first.dtype:
                raise ValueError(f"{p}: inconsistent shard shape/dtype ({m.shape}, {m.dtype})")
        self.dtype_name = dtype or first.dtype.name
        if self.dtype_name == _BF16 and first.dtype.itemsize != 2:
            raise ValueError(f"cache dtype bfloat16 does not match shard dtype {first.dtype}")
        self.dim = int(first.shape[1])
        self.rows_per_shard = [int(m.shape[0]) for m in self._mmaps]
        self.num_rows = int(sum(self.rows_per_shard))
        self.row_bytes = self.dim * first.dtype.itemsize
        self._cum = np.cumsum([0] + self.rows_per_shard)

    def gather(self, indices) -> torch.Tensor:
        """Rows ``indices`` (any order) as a CPU tensor ``[len, dim]``."""
        indices = np.ascontiguousarray(indices, np.int64)
        out = np.empty((len(indices), self.dim), self._mmaps[0].dtype)
        shard_ids = np.searchsorted(self._cum, indices, side="right") - 1
        local = indices - self._cum[shard_ids]
        for s in range(len(self.paths)):
            m = shard_ids == s
            if m.any():
                out[m] = self._mmaps[s][local[m]]
        return rows_to_tensor(out, self.dtype_name)


class PrefetchLoader:
    """Shuffling batch loader over a :class:`ShardReader`: a new order each
    epoch, the final partial batch included, the next batch gathered on a
    worker thread while the caller uses the current one.  Asked for fused
    epochs (``SAETrainer.train(loader, fused=True)``), the trainer gathers
    chunks from ``reader`` instead (``train_epoch_out_of_core``)."""

    def __init__(self, reader: ShardReader, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2):
        self.reader = reader
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    @property
    def num_tokens(self) -> int:
        return self.reader.num_rows

    def __len__(self) -> int:
        return math.ceil(self.reader.num_rows / self.batch_size)

    def __iter__(self):
        n = self.reader.num_rows
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def worker():
            try:
                for start in range(0, n, self.batch_size):
                    q.put(self.reader.gather(order[start:start + self.batch_size]))
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                break
            yield batch
        t.join()
