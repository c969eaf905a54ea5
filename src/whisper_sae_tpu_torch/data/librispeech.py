"""Audio datasets and batching for extraction (counterpart of
``whisper_sae_tpu/data/librispeech.py``).

:class:`LibriSpeechDataset` is the real-audio route: a sample stream
(HF ``datasets`` LibriSpeech, or any iterable of samples of that schema)
is decoded (soundfile when importable, else the stdlib WAV reader),
resampled to 16 kHz on the host, averaged over channels, featurised with
the port's log-mel (``data/mel.py``) on the dataset's device, and written
as bounded ``.npy`` shards plus one meta json -- the JAX package's cache
layout and stem, so a cache either package wrote loads in the other.
:class:`SyntheticSpeechDataset` draws the same waveforms as the JAX
package's from the same ``np.random.default_rng(seed * 100_003 + i)``
streams and featurises them in chunks of 64, on the device it is given.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from ..config import DataConfig
from ..utils.device import resolve_device
from ..utils.wavio import resample
from .mel import SAMPLE_RATE, log_mel_spectrogram


class _ShardedMels:
    """Lazy row access over a list of .npy mel shards (memmap per shard)."""

    def __init__(self, paths: list[Path]):
        self.paths = paths
        self._maps = [np.load(p, mmap_mode="r") for p in paths]
        self._cum = np.cumsum([0] + [m.shape[0] for m in self._maps])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, i: int) -> np.ndarray:
        s = int(np.searchsorted(self._cum, i, side="right")) - 1
        return self._maps[s][i - self._cum[s]]


class LibriSpeechDataset:
    """LibriSpeech with an on-disk mel cache.

    Each item: ``{"input_features": [n_mels, 3000] float32, "id": str,
    "text": str, "speaker_id": int, "chapter_id": int}``.  The cache under
    ``config.cache_dir`` is keyed by ``librispeech_{subset}_{split}_{max}``
    (``_mel{n}`` added when ``n_mels != 80``): a meta json
    ``{"shards": [...], "items": [...]}`` listing ``.npy`` shards of
    ``SHARD_MELS`` mels, or the legacy single ``.npy`` beside a list of
    items.  Without a cache the stream is ingested (``_load_streaming``:
    HF ``datasets``, which needs the network).  ``device`` is where the
    log-mel runs during ingest: the card unless the caller asks for the
    CPU (a cache that exists needs none).
    """

    def __init__(self, config: DataConfig, processor: Any | None = None, n_mels: int = 80,
                 device: str | torch.device | None = None):
        self.config = config
        self.processor = processor  # optional WhisperProcessor, called per sample
        self.n_mels = n_mels  # 128 for large-v3
        self.device = device
        self.cache_dir = Path(config.cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        stem = f"librispeech_{config.dataset_subset}_{config.dataset_split}_{config.max_samples}"
        if n_mels != 80:  # 80-bin caches keep their names
            stem += f"_mel{n_mels}"
        self._stem = stem
        self._feat_path = self.cache_dir / f"{stem}.npy"
        self._meta_path = self.cache_dir / f"{stem}_meta.json"
        self._features: np.ndarray | _ShardedMels | None = None
        self._meta: list[dict] | None = None
        if self._meta_path.exists():
            self._meta = json.loads(self._meta_path.read_text())
            if isinstance(self._meta, dict):  # sharded layout
                self._features = _ShardedMels([self.cache_dir / s for s in self._meta["shards"]])
                self._meta = self._meta["items"]
            elif self._feat_path.exists():  # legacy single-file layout
                self._features = np.load(self._feat_path, mmap_mode="r")
            else:
                self._load_streaming()
        else:
            self._load_streaming()

    # one [80, 3000] f32 mel is ~0.92 MB: 256 a shard bounds what ingest
    # holds at any corpus size
    SHARD_MELS = 256

    def _load_streaming(self) -> None:
        try:
            from datasets import Audio, load_dataset
        except ImportError as e:
            raise RuntimeError(
                "HF `datasets` is required to stream LibriSpeech; use "
                "SyntheticSpeechDataset for offline runs"
            ) from e
        ds = load_dataset(
            self.config.dataset_name,
            self.config.dataset_subset,
            split=self.config.dataset_split,
            streaming=self.config.streaming,
        )
        ds = ds.cast_column("audio", Audio(decode=False))
        self._ingest(iter(ds))

    def _ingest(self, samples) -> None:
        """Featurise a sample stream into bounded .npy shards (each written
        to a temporary name and renamed) and one meta json listing them; a
        sample that fails to decode or featurise is skipped."""
        # resolved once, outside the per-sample skip: no card raises here
        dev = None if self.processor is not None else resolve_device(self.device)
        buf: list[np.ndarray] = []
        meta: list[dict] = []
        shard_names: list[str] = []

        def flush():
            if not buf:
                return
            name = f"{self._stem}_shard{len(shard_names):05d}.npy"
            tmp = self.cache_dir / (name + ".tmp.npy")
            np.save(tmp, np.stack(buf).astype(np.float32))
            tmp.rename(self.cache_dir / name)
            shard_names.append(name)
            buf.clear()

        for i, sample in enumerate(samples):
            if i >= self.config.max_samples:
                break
            try:
                audio, rate = self._decode(sample["audio"])
                audio = resample(audio, rate, SAMPLE_RATE)
                if audio.ndim > 1:
                    audio = audio.mean(axis=1)
                buf.append(self._featurize(audio, dev))
                meta.append({
                    "id": sample.get("id", str(i)),
                    "text": sample.get("text", ""),
                    "speaker_id": sample.get("speaker_id", -1),
                    "chapter_id": sample.get("chapter_id", -1),
                })
            except Exception:  # per-sample resilience: a bad clip is skipped
                continue
            if len(buf) >= self.SHARD_MELS:
                flush()
        flush()
        tmp = self._meta_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps({"shards": shard_names, "items": meta}))
        tmp.rename(self._meta_path)
        self._features = _ShardedMels([self.cache_dir / s for s in shard_names])
        self._meta = meta

    @staticmethod
    def _decode(audio_field: dict) -> tuple[np.ndarray, int]:
        """(waveform [n] or [n, ch] float32, rate) from the sample's bytes,
        else its path."""
        raw = audio_field.get("bytes")
        path = audio_field.get("path", "")
        try:
            import io

            import soundfile as sf

            data, rate = sf.read(io.BytesIO(raw) if raw else path, dtype="float32")
            return data, rate
        except ImportError:
            from ..utils.wavio import read_wav

            if raw is not None and raw[:4] == b"RIFF":
                import tempfile

                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    f.write(raw)
                    f.flush()
                    return read_wav(f.name)
            return read_wav(path)

    def _featurize(self, audio: np.ndarray, device: torch.device | None) -> np.ndarray:
        """[n_mels, 3000] float32: the processor's features when one is
        given, else the port's log-mel on ``device``."""
        if self.processor is not None:
            out = self.processor(audio, sampling_rate=SAMPLE_RATE, return_tensors="np")
            return np.asarray(out.input_features[0], np.float32)
        return log_mel_spectrogram(audio, n_mels=self.n_mels, device=device)[0].cpu().numpy()

    def __len__(self) -> int:
        return len(self._meta)

    def __getitem__(self, i: int) -> dict:
        return {"input_features": np.asarray(self._features[i]), **self._meta[i]}


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


def create_librispeech_dataloader(
    processor: Any = None,
    config: DataConfig | None = None,
    batch_size: int = 16,
    num_workers: int = 4,
    shuffle: bool = True,
    pin_memory: bool = True,
) -> AudioBatchLoader:
    """Batches of a :class:`LibriSpeechDataset`'s mels, with the
    reference's argument surface (processor, config, batch_size,
    num_workers, shuffle); the first positional may be the processor or a
    :class:`DataConfig`.  ``num_workers`` and ``pin_memory`` are accepted
    and ignored (batches are a memmap gather)."""
    if config is None and isinstance(processor, DataConfig):
        processor, config = None, processor
    if config is None:
        raise TypeError("create_librispeech_dataloader requires a DataConfig")
    del num_workers, pin_memory  # accepted for the reference's surface
    ds = LibriSpeechDataset(config, processor=processor)
    return AudioBatchLoader(LibriSpeechFeaturesOnly(ds), batch_size=batch_size, shuffle=shuffle)
