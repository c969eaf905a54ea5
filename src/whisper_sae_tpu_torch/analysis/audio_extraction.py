"""Audio clip extraction for feature interpretation (a copy of
``whisper_sae_tpu/analysis/audio_extraction.py`` over the port's WAV codec
and tracker: the same clip bytes and manifest for the same tracker).

The reference's AudioClipConfig defaults (16 kHz, 160 samples/frame, 1 s
clips, 500 ms pre-context, peak-normalize to 0.95), the
``feature_{i:05d}/rank{r:02d}_act{v:.3f}.wav`` layout, the manifest.json
schema, and the seek-forward streaming / indexed audio loaders; audio IO
is the port's own WAV codec (utils/wavio.py) and a synthetic loader
covers air-gapped runs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

from ..utils.wavio import read_wav, write_wav
from .feature_viz import FeatureActivation, TopKTracker


@dataclass
class AudioClipConfig:
    """Clip extraction config (reference audio_extraction.py:23-33)."""

    sample_rate: int = 16_000
    samples_per_frame: int = 160  # 10 ms at 16 kHz
    clip_duration_ms: float = 1000.0
    context_before_ms: float = 500.0
    output_format: str = "wav"
    normalize_audio: bool = True


class AudioClipExtractor:
    """Extract audio clips centered on high-activation positions."""

    def __init__(
        self,
        tracker: TopKTracker,
        audio_loader: Callable[[int], np.ndarray],
        output_dir: Path | str,
        config: AudioClipConfig | None = None,
    ):
        self.tracker = tracker
        self.audio_loader = audio_loader
        self.output_dir = Path(output_dir)
        self.config = config or AudioClipConfig()
        self.output_dir.mkdir(parents=True, exist_ok=True)
        # feature_idx -> {rank -> clip path}, for the manifest
        self._clip_paths: dict[int, dict[int, str]] = {}

    def _frame_to_sample(self, frame_idx: int) -> int:
        return frame_idx * self.config.samples_per_frame

    def _ms_to_samples(self, ms: float) -> int:
        return int(ms * self.config.sample_rate / 1000)

    def extract_clip(
        self, activation: FeatureActivation, audio: np.ndarray | None = None
    ) -> np.ndarray | None:
        """One clip: [start = center - context, start + duration], peak
        normalized (reference audio_extraction.py:81-119)."""
        if audio is None:
            try:
                audio = self.audio_loader(activation.sample_idx)
            except Exception:
                return None
        audio = np.asarray(audio)
        if audio.ndim == 2:
            audio = audio.squeeze(0) if audio.shape[0] == 1 else audio.mean(axis=1)

        center = self._frame_to_sample(activation.position_idx)
        context = self._ms_to_samples(self.config.context_before_ms)
        clip_len = self._ms_to_samples(self.config.clip_duration_ms)
        start = max(0, center - context)
        end = min(len(audio), start + clip_len)
        if end <= start:
            # activation frame beyond the (padded-to-30s) audio length
            return None
        clip = audio[start:end]
        if self.config.normalize_audio and np.abs(clip).max() > 0:
            clip = clip / np.abs(clip).max() * 0.95
        return clip

    def extract_feature_clips(
        self, feature_idx: int, max_clips: int | None = None
    ) -> list[Path]:
        examples = self.tracker.get_top_examples(feature_idx)
        if max_clips:
            examples = examples[:max_clips]
        feature_dir = self.output_dir / f"feature_{feature_idx:05d}"
        feature_dir.mkdir(exist_ok=True)

        saved: list[Path] = []
        audio_cache: dict[int, np.ndarray] = {}
        for rank, activation in enumerate(examples):
            si = activation.sample_idx
            if si not in audio_cache:
                try:
                    audio_cache[si] = self.audio_loader(si)
                except Exception as e:
                    print(f"Failed to load audio for sample {si}: {e}")
                    continue
            clip = self.extract_clip(activation, audio_cache[si])
            if clip is None or len(clip) == 0:
                continue
            clip_path = feature_dir / (
                f"rank{rank:02d}_act{activation.activation_value:.3f}."
                f"{self.config.output_format}"
            )
            write_wav(clip_path, clip, self.config.sample_rate)
            saved.append(clip_path)
            activation.audio_path = str(clip_path)
            self._clip_paths.setdefault(feature_idx, {})[rank] = str(clip_path)
        return saved

    def extract_all_clips(
        self,
        feature_indices: list[int] | None = None,
        max_clips_per_feature: int | None = None,
        progress_callback: Callable[[int, int], None] | None = None,
    ) -> dict[int, list[Path]]:
        if feature_indices is None:
            feature_indices = [
                i
                for i in range(self.tracker.num_features)
                if self.tracker.get_top_examples(i)
            ]
        all_clips: dict[int, list[Path]] = {}
        total = len(feature_indices)
        for idx, fi in enumerate(feature_indices):
            if progress_callback:
                progress_callback(idx, total)
            clips = self.extract_feature_clips(fi, max_clips=max_clips_per_feature)
            if clips:
                all_clips[fi] = clips
        return all_clips

    def save_manifest(self) -> Path:
        """manifest.json (reference audio_extraction.py:231-267)."""
        manifest = {
            "config": {
                "sample_rate": self.config.sample_rate,
                "clip_duration_ms": self.config.clip_duration_ms,
                "output_format": self.config.output_format,
            },
            "features": {},
        }
        for fi in range(self.tracker.num_features):
            examples = self.tracker.get_top_examples(fi)
            entries = []
            for rank, ex in enumerate(examples):
                path = self._clip_paths.get(fi, {}).get(rank)
                if path is None:
                    continue
                entries.append(
                    {
                        "rank": rank,
                        "activation_value": ex.activation_value,
                        "sample_idx": ex.sample_idx,
                        "position_idx": ex.position_idx,
                        "timestamp_ms": ex.timestamp_ms,
                        "audio_path": path,
                        "transcription": ex.transcription,
                    }
                )
            if entries:
                manifest["features"][str(fi)] = entries
        manifest_path = self.output_dir / "manifest.json"
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest_path


def create_librispeech_audio_loader(
    dataset_path: str | None = None, split: str = "train.100"
) -> Callable[[int], np.ndarray]:
    """Seek-forward streaming loader with cache
    (reference audio_extraction.py:270-321).  Requires HF `datasets` +
    network."""
    import io

    from datasets import Audio, load_dataset

    dataset = load_dataset(
        "librispeech_asr", "clean", split=split, streaming=True
    ).cast_column("audio", Audio(decode=False))

    _cache: dict[int, np.ndarray] = {}
    _iter = iter(dataset)
    _state = {"idx": 0}

    def load_audio(sample_idx: int) -> np.ndarray:
        if sample_idx in _cache:
            return _cache[sample_idx]
        while _state["idx"] <= sample_idx:
            try:
                sample = next(_iter)
            except StopIteration:
                raise IndexError(f"Sample index {sample_idx} out of range")
            raw = sample["audio"]["bytes"]
            try:
                import soundfile as sf

                arr, _ = sf.read(io.BytesIO(raw), dtype="float32")
            except ImportError:
                import tempfile

                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    f.write(raw)
                    f.flush()
                    arr, _ = read_wav(f.name)
            _cache[_state["idx"]] = np.asarray(arr, np.float32)
            _state["idx"] += 1
        return _cache[sample_idx]

    return load_audio


def create_indexed_audio_loader(
    audio_paths: list[Path | str],
) -> Callable[[int], np.ndarray]:
    """Loader over a path list (reference audio_extraction.py:324-345)."""

    def load_audio(sample_idx: int) -> np.ndarray:
        if sample_idx >= len(audio_paths):
            raise IndexError(f"Sample index {sample_idx} out of range")
        arr, _ = read_wav(audio_paths[sample_idx])
        return np.asarray(arr, np.float32)

    return load_audio


def create_synthetic_audio_loader(dataset) -> Callable[[int], np.ndarray]:
    """Loader over a SyntheticSpeechDataset (offline runs)."""

    def load_audio(sample_idx: int) -> np.ndarray:
        return dataset.waveform(sample_idx)

    return load_audio
