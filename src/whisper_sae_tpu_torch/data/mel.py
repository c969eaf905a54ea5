"""Whisper log-mel frontend (counterpart of ``whisper_sae_tpu/data/mel.py``).

The same numerics as HF ``WhisperFeatureExtractor``: hann(400) STFT with
hop 160, centre/reflect padding, power spectrogram, slaney mel
filterbank, log10 clamp at 1e-10, dynamic-range floor at (max - 8) over
the spectrogram without its last frame, then (x + 4) / 4.  30 s at
16 kHz gives ``[n_mels, 3000]``.  Runs on the device of the waveform
tensor it is given; the filterbank is the port's own numpy copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import f32_matmuls

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH_S  # 480_000


def _hertz_to_mel_slaney(freq) -> np.ndarray:
    freq = np.asarray(freq, np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )


def _mel_to_hertz_slaney(mels) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        1000.0 * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freq,
    )


def mel_filter_bank(
    num_frequency_bins: int = N_FFT // 2 + 1,
    num_mel_filters: int = N_MELS,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular mel filterbank
    ``[num_frequency_bins, num_mel_filters]`` (float32)."""
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    mel_points = np.linspace(_hertz_to_mel_slaney(min_frequency),
                             _hertz_to_mel_slaney(max_frequency), num_mel_filters + 2)
    filter_freqs = _mel_to_hertz_slaney(mel_points)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb *= (2.0 / (filter_freqs[2:] - filter_freqs[:-2]))[None, :]
    return fb.astype(np.float32)


_MEL_FB: dict[int, np.ndarray] = {}


def _mel_fb(n_mels: int) -> np.ndarray:
    if n_mels not in _MEL_FB:
        _MEL_FB[n_mels] = mel_filter_bank(num_mel_filters=n_mels)
    return _MEL_FB[n_mels]


def log_mel_spectrogram(audio, pad_to_chunk: bool = True, n_mels: int = N_MELS,
                        device: str | torch.device | None = None) -> torch.Tensor:
    """Whisper log-mel features.

    Args:
        audio: ``[n]`` or ``[B, n]`` waveform at 16 kHz (tensor or array).
        pad_to_chunk: zero-pad or truncate to 30 s, giving 3000 frames.
        n_mels: 80 (every model through large-v2) or 128 (large-v3).
        device: where to compute; default the tensor's own device (the
            CPU for a numpy array).

    Returns:
        ``[B, n_mels, T]`` float32 on that device.
    """
    x = torch.as_tensor(np.asarray(audio) if not isinstance(audio, torch.Tensor) else audio)
    x = x.to(device=device, dtype=torch.float32)
    if x.dim() == 1:
        x = x[None]
    if pad_to_chunk:
        n = x.shape[1]
        x = torch.nn.functional.pad(x, (0, N_SAMPLES - n)) if n < N_SAMPLES else x[:, :N_SAMPLES]
    pad = N_FFT // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, N_FFT, HOP_LENGTH)  # [B, n // hop + 1, N_FFT]
    window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * window, n=N_FFT, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [B, T, 201]
    fb = torch.from_numpy(_mel_fb(n_mels)).to(x.device)
    with f32_matmuls():
        mel = torch.matmul(power, fb).transpose(1, 2).contiguous()  # [B, n_mels, T]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))[..., :-1]
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0
