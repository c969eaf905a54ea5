"""The port's transcription job (``launch transcribe``), its wav reader and
writer (``utils/wavio.py``) and WER (``utils/metrics.py``) against the
JAX package's, on the CPU: the same bytes, arrays and rates, and the
same token ids from the same parameters."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.utils import metrics as jmetrics
from whisper_sae_tpu.utils import wavio as jwavio
from whisper_sae_tpu_torch import launch
from whisper_sae_tpu_torch.models import whisper as TW
from whisper_sae_tpu_torch.utils import metrics as tmetrics
from whisper_sae_tpu_torch.utils import wavio as twavio

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_bytes_and_read_wav_match_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    audio = (rng.standard_normal((4000, channels) if channels > 1 else 4000) * 0.4).astype(
        np.float32)
    audio[:3] = [1.5, -1.5, 0.0] if channels == 1 else [[1.5, -2], [-1.5, 2], [0, 0]]  # clipped
    twavio.write_wav(tmp_path / "t.wav", audio, sample_rate=22_050)
    jwavio.write_wav(tmp_path / "j.wav", audio, sample_rate=22_050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, rate = twavio.read_wav(tmp_path / "t.wav")
    want, jrate = jwavio.read_wav(tmp_path / "t.wav")
    assert rate == jrate == 22_050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rates", [(8_000, 16_000), (44_100, 16_000), (16_000, 16_000)])
def test_resample_matches_jax(rates):
    audio = np.random.default_rng(0).standard_normal(44_100).astype(np.float32)
    got = twavio.resample(audio, *rates)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jwavio.resample(audio, *rates))


@pytest.mark.parametrize("ref,hyp", [
    ("", ""),
    ("", "extra words"),
    ("HELLO WORLD", "hello, world!"),
    ("the cat sat", "the cat sat on the mat"),
    ("it's a test of the system", "its a test the system"),
    ("one two three", ""),
])
def test_wer_matches_jax(ref, hyp):
    assert tmetrics.wer(ref, hyp) == jmetrics.wer(ref, hyp)
    pairs = [(ref, hyp), ("A B C", "a x c"), (hyp, ref)]
    assert tmetrics.corpus_wer(pairs) == jmetrics.corpus_wer(pairs)


def _clip_dir(tmp_path: Path) -> tuple[Path, Path]:
    """A directory holding one 1 s wav at 8 kHz (resampled by the job)."""
    d = tmp_path / "clips"
    d.mkdir()
    wav = d / "clip.wav"
    twavio.write_wav(wav, np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.1,
                     sample_rate=8000)
    return d, wav


def test_transcribe_synthetic_offline(tmp_path):
    """Random weights, a wav directory and a synthetic clip through the CLI:
    EOS-trimmed ids starting with the start token, the JSON written."""
    d, wav = _clip_dir(tmp_path)
    out_path = tmp_path / "transcripts.json"
    summary = launch.main(["transcribe", str(d), "--random-whisper", "--max-len", "3",
                           "--num-synthetic", "1", "--output", str(out_path), "--device", "cpu"])
    assert summary["num_clips"] == 2 and "transcripts" not in summary
    saved = json.loads(out_path.read_text())
    assert set(saved) == {"model_name", "num_clips", "elapsed_s", "transcripts"}
    assert set(saved["transcripts"]) == {str(wav), "synthetic_0"}
    for entry in saved["transcripts"].values():
        assert set(entry) == {"token_ids"}
        assert entry["token_ids"][0] == 50258 and 1 <= len(entry["token_ids"]) <= 3


def test_transcribe_ragged_final_batch(monkeypatch):
    """3 clips at batch 2: the final batch is padded to the batch shape and
    the pad row's transcript dropped."""
    shapes = []
    real = launch.greedy_decode_cached

    def spy(params, mel, *args, **kwargs):
        shapes.append(tuple(mel.shape))
        return real(params, mel, *args, **kwargs)

    monkeypatch.setattr(launch, "greedy_decode_cached", spy)
    res = launch.transcribe_job(random_whisper=True, max_len=3, num_synthetic=3, batch_size=2,
                                device="cpu")
    assert res["num_clips"] == 3
    assert set(res["transcripts"]) == {"synthetic_0", "synthetic_1", "synthetic_2"}
    assert shapes == [(2, 80, 3000), (2, 80, 3000)]


def test_transcribe_ids_match_jax_job(tmp_path, monkeypatch):
    """whisper-tiny, f32, max_len 3: the port's job with the JAX job's
    weights (``init_whisper(PRNGKey(0))`` carried over) gives the JAX job's
    ids on the same inputs."""
    spec = importlib.util.spec_from_file_location("_jax_launcher", REPO / "launcher" / "launch.py")
    jlaunch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlaunch)
    d, _ = _clip_dir(tmp_path)
    kw = dict(inputs=[str(d)], random_whisper=True, max_len=3, num_synthetic=1)
    want = jlaunch.transcribe_job(**kw)
    jparams = JW.init_whisper(jax.random.PRNGKey(0), JW.arch_for("openai/whisper-tiny"))
    tparams = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    monkeypatch.setattr(launch, "init_whisper", lambda gen, arch: tparams)
    got = launch.transcribe_job(device="cpu", **kw)
    assert got["num_clips"] == want["num_clips"] == 2
    assert got["transcripts"] == want["transcripts"]
