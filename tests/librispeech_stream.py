"""A LibriSpeech-shaped sample stream made from a seed with numpy, for the
port's tests of ``LibriSpeechDataset`` (imports neither jax nor torch).

Each sample is the schema HF ``datasets`` streams with ``Audio(decode=
False)``: ``{"audio": {"bytes": RIFF WAV or None, "path": str}, "id",
"text", "speaker_id", "chapter_id"}``.  The clips are harmonic tones under
an AM envelope: 16 kHz mono by default, every third one 22.05 kHz stereo
(so resampling and the channel mean run), and the samples named in
``bad`` carry bytes that no WAV reader decodes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

MONO_RATE, STEREO_RATE = 16_000, 22_050


def wav_bytes(audio: np.ndarray, rate: int) -> bytes:
    """16-bit PCM RIFF bytes of ``audio`` ([n] or [n, ch] in [-1, 1]), as
    ``utils/wavio.write_wav`` writes them."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    n_ch = audio.shape[1]
    data = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, n_ch, rate, rate * n_ch * 2, n_ch * 2, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def tone(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    t = np.arange(n) / rate
    f0 = rng.uniform(90.0, 250.0)
    audio = sum(rng.uniform(0.1, 1.0) / h * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28))
                for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t))
    audio = audio * env + 0.01 * rng.standard_normal(n)
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)


def sample_stream(n: int, seed: int, bad: tuple = (), path_dir: Path | None = None,
                  seconds: tuple = (1.0, 1.5)) -> list[dict]:
    """``n`` samples; with ``path_dir`` every fourth good one is a WAV file
    there, referenced by path with no bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid, cid = 100 + i % 3, 7 + i // 3
        sample = {"id": f"{sid}-{cid}-{i:04d}", "text": f"UTTERANCE NUMBER {i} OF THE STREAM",
                  "speaker_id": sid, "chapter_id": cid}
        if i in bad:
            sample["audio"] = {"bytes": b"RIFF\x10\x00\x00\x00WAVEnot a wave", "path": f"{i}.wav"}
            out.append(sample)
            continue
        if i % 3 == 2:  # 22.05 kHz stereo: one second, 16000 samples once resampled
            left, right = tone(rng, STEREO_RATE, STEREO_RATE), tone(rng, STEREO_RATE, STEREO_RATE)
            raw = wav_bytes(np.stack([left, 0.5 * right], axis=1), STEREO_RATE)
        else:
            raw = wav_bytes(tone(rng, int(seconds[i % 2] * MONO_RATE), MONO_RATE), MONO_RATE)
        if path_dir is not None and i % 4 == 3:
            path = Path(path_dir) / f"{sample['id']}.wav"
            path.write_bytes(raw)
            sample["audio"] = {"bytes": None, "path": str(path)}
        else:
            sample["audio"] = {"bytes": raw, "path": f"{sample['id']}.flac"}
        out.append(sample)
    return out
