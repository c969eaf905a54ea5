"""Audio datasets and batching for extraction (counterpart of
``whisper_sae_tpu/data/librispeech.py:202-318``).

:class:`SyntheticSpeechDataset` draws the same waveforms as the JAX
package's from the same ``np.random.default_rng(seed * 100_003 + i)``
streams and featurises them with the port's log-mel (``data/mel.py``) in
chunks of 64, on the device it is given.  ``LibriSpeechDataset`` is not
ported: it streams data that is not in the repository.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .mel import SAMPLE_RATE, log_mel_spectrogram


class SyntheticSpeechDataset:
    """Deterministic offline stand-in with the LibriSpeech item schema:
    harmonic tones under formant-like AM envelopes."""

    # one batched log-mel per 64 items, with a 2-chunk LRU (sequential
    # extraction touches each chunk exactly once)
    MEL_CHUNK = 64

    def __init__(self, num_samples: int = 16, duration_s: float = 2.0, seed: int = 0,
                 n_mels: int = 80, device: str | torch.device = "cpu"):
        self.num_samples = num_samples
        self.duration_s = duration_s
        self.seed = seed
        self.n_mels = n_mels
        self.device = torch.device(device)
        self._mel_chunks: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_samples

    def _mel_chunk(self, c: int) -> np.ndarray:
        if c not in self._mel_chunks:
            lo = c * self.MEL_CHUNK
            hi = min(lo + self.MEL_CHUNK, self.num_samples)
            waves = np.stack([self._waveform(i) for i in range(lo, hi)])
            mel = log_mel_spectrogram(waves, n_mels=self.n_mels, device=self.device)
            self._mel_chunks[c] = mel.cpu().numpy()
            while len(self._mel_chunks) > 2:
                self._mel_chunks.pop(next(iter(self._mel_chunks)))
        return self._mel_chunks[c]

    def _waveform(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100_003 + i)
        n = int(self.duration_s * SAMPLE_RATE)
        t = np.arange(n) / SAMPLE_RATE
        f0 = rng.uniform(90.0, 250.0)
        audio = np.zeros(n, np.float32)
        for h in range(1, 6):
            audio += rng.uniform(0.1, 1.0) / h * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)
            )
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t))
        audio = audio * env + 0.01 * rng.standard_normal(n)
        return (0.5 * audio / np.abs(audio).max()).astype(np.float32)

    def __getitem__(self, i: int) -> dict:
        chunk = self._mel_chunk(i // self.MEL_CHUNK)
        return {
            "input_features": chunk[i % self.MEL_CHUNK],
            "id": f"synthetic-{i}",
            "text": f"synthetic utterance {i}",
            "speaker_id": i % 7,
            "chapter_id": i // 7,
        }

    def waveform(self, i: int) -> np.ndarray:
        return self._waveform(i)


class LibriSpeechFeaturesOnly:
    """Yields only ``input_features``; with ``record_texts`` it keeps each
    accessed item's text in ``self.texts`` (index -> text)."""

    def __init__(self, dataset, record_texts: bool = False):
        self.dataset = dataset
        self.texts: dict[int, str] = {}
        self._record = record_texts

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int) -> np.ndarray:
        item = self.dataset[i]
        if self._record and isinstance(item, dict) and item.get("text"):
            self.texts[i] = item["text"]
        return item["input_features"]


class AudioBatchLoader:
    """Batches ``input_features`` from a dataset as numpy ``[B, n_mels, T]``."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            items = [self.dataset[int(i)] for i in order[start:start + self.batch_size]]
            if isinstance(items[0], dict):
                yield np.stack([it["input_features"] for it in items])
            else:
                yield np.stack(items)
