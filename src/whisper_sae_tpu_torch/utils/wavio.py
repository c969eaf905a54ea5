"""Minimal WAV read/write (PCM 8/16/24/32 and float32/64, any channel count).

The port's own copy of ``whisper_sae_tpu/utils/wavio.py`` (numpy and
scipy only): ``write_wav`` gives the same bytes, ``read_wav`` and
``resample`` the same arrays.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int = 16_000) -> None:
    """Write float waveform in [-1, 1] as 16-bit PCM WAV.

    ``audio``: [n] mono or [n, channels].
    """
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    n_frames, n_ch = audio.shape
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    byte_rate = sample_rate * n_ch * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, n_ch, sample_rate, byte_rate, n_ch * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 waveform [n] or [n, ch] in [-1, 1], rate)."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(raw) >= 24:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits in (8, 16, 24, 32) else 3
    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(data, "<u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(data, np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dt).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch)
    return x, rate


def resample(audio: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy), mono or [n, ch]."""
    if orig_rate == target_rate:
        return audio.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_rate, target_rate)
    out = resample_poly(audio, target_rate // g, orig_rate // g, axis=0)
    return out.astype(np.float32)
