"""The port's log-mel frontend against the JAX package's, on the CPU.

Tolerance: max abs 1e-4 on values of order 1 (the two FFTs sum in other
orders; measured up to 1.5e-5), the filterbank to 1e-7.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_sae_tpu.data import mel as jmel
from whisper_sae_tpu_torch.data import mel as tmel

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs one worker process per core: keep torch's intra-op
    pool to one thread here, or the workers' pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_samples", [16_000, tmel.N_SAMPLES, 600_000])
def test_log_mel_matches_jax(n_samples, n_mels):
    audio = (np.random.default_rng(n_samples + n_mels).standard_normal((2, n_samples))
             * 0.3).astype(np.float32)
    want = np.asarray(jmel.log_mel_spectrogram(audio, n_mels=n_mels))
    got = tmel.log_mel_spectrogram(audio, n_mels=n_mels)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, n_mels, 3000)
    err = float(np.abs(got.numpy() - want).max())
    print(f"log-mel max abs err {err:.3g}")
    assert err <= 1e-4


def test_log_mel_unpadded_and_1d():
    audio = (np.random.default_rng(3).standard_normal(40_000) * 0.2).astype(np.float32)
    want = np.asarray(jmel.log_mel_spectrogram(audio, pad_to_chunk=False))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), pad_to_chunk=False)
    assert tuple(got.shape) == want.shape == (1, 80, 250)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filter_bank_matches_jax(n_mels):
    want = jmel.mel_filter_bank(num_mel_filters=n_mels)
    got = tmel.mel_filter_bank(num_mel_filters=n_mels)
    assert got.dtype == np.float32 and got.shape == want.shape == (201, n_mels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_log_mel_is_contiguous():
    """The kernels read mel batches raw: the frontend hands them over in
    row-major order (numpy stacks of strided rows would keep the strides)."""
    mel = tmel.log_mel_spectrogram(np.zeros((2, 16_000), np.float32))
    assert mel.is_contiguous()
    assert np.stack([mel.numpy()[0], mel.numpy()[1]]).flags.c_contiguous
