"""The port's CLI (``python -m whisper_sae_tpu_torch.train``) on the CPU:
training from a small synthetic cache in the JAX package's format, and
extraction into such a cache."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from whisper_sae_tpu.config import DataConfig, WhisperConfig
from whisper_sae_tpu.data.feature_cache import FeatureCache
from whisper_sae_tpu_torch import train as cli

REPO = Path(__file__).resolve().parent.parent
D, N = 128, 1000

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs one worker process per core: keep torch's intra-op
    pool to one thread here, or the workers' pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _config(tmp_path: Path, epochs: int = 3) -> Path:
    cfg = yaml.safe_load((REPO / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"].update(expansion_factor=4, k=8, dead_feature_threshold=20)
    cfg["training"].update(batch_size=64, learning_rate=3e-3, epochs=epochs, warmup_steps=5)
    cfg["data"]["cache_dir"] = str(tmp_path / "cache")
    cfg["output_dir"] = str(tmp_path / "out")
    cfg["experiment_name"] = "port"
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _cache(tmp_path: Path, dtype: str = "float32") -> None:
    """Rows that a dictionary of 32 directions explains, written by the
    JAX package's cache writer."""
    rng = np.random.default_rng(0)
    atoms = rng.standard_normal((32, D)).astype(np.float32)
    codes = rng.exponential(1.0, (N, 32)) * (rng.random((N, 32)) < 0.1)
    rows = (codes @ atoms + 0.05 * rng.standard_normal((N, D))).astype(np.float32)
    cache = FeatureCache(tmp_path / "cache" / "features", WhisperConfig(), DataConfig())
    writer = cache.writer("encoder", 0, dtype=dtype)
    writer.append(rows)
    writer.finalize(num_samples=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_trains_from_cache(tmp_path, dtype):
    cfg = _config(tmp_path)
    _cache(tmp_path, dtype)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_sae_tpu_torch.train", "--config", str(cfg),
         "--device", "cpu", "--no-wandb", "--layer", "encoder:0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run = tmp_path / "out" / "port_encoder_layer0"
    for name in ("metrics.json", "sae_final.npz", "sae_final.pt", "final.npz",
                 "training_config.json"):
        assert (run / name).exists(), name
    rows = json.loads((run / "metrics.json").read_text())
    assert len(rows) == 3 * 16  # ceil(1000 / 64) steps per epoch
    assert set(rows[0]) == {"step", "loss", "reconstruction_loss", "sparsity_loss", "l0",
                            "dead_feature_ratio", "learning_rate"}
    first, last = np.mean([r["loss"] for r in rows[:5]]), np.mean([r["loss"] for r in rows[-5:]])
    assert last < 0.5 * first
    with np.load(run / "sae_final.npz") as z:
        assert sorted(z.files) == ["b_dec", "b_enc", "b_pre", "w_dec", "w_enc"]
        np.testing.assert_allclose(np.linalg.norm(z["w_dec"], axis=1), 1.0, rtol=1e-5)
    sd = torch.load(run / "sae_final.pt")
    assert tuple(sd["encoder.weight"].shape) == (4 * D, D)


def test_cli_returns_trainers_and_resumes(tmp_path):
    cfg = _config(tmp_path, epochs=1)
    _cache(tmp_path)
    args = ["--config", str(cfg), "--device", "cpu", "--no-wandb", "--layer", "encoder:0"]
    (trainer,) = cli.main(args).values()
    assert trainer.global_step == 16 and trainer.model.device.type == "cpu"
    final = tmp_path / "out" / "port_encoder_layer0" / "final.npz"
    (resumed,) = cli.main(args + ["--resume", str(final)]).values()
    assert resumed.global_step == 16  # the one epoch was already done


def _synthetic(cfg_path: Path, samples: int = 2) -> Path:
    """The config switched to the synthetic dataset, ``samples`` clips."""
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["data"].update(dataset_name="synthetic", max_samples=samples)
    cfg["training"].update(epochs=1, batch_size=256)
    cfg_path.write_text(yaml.safe_dump(cfg))
    return cfg_path


@pytest.mark.parametrize("extra", [[], ["--extract-only"], ["--random-whisper"]])
def test_cli_extraction_not_ported(tmp_path, monkeypatch, extra):
    """Extraction in the CLI (whisper-tiny, random weights, 2 synthetic
    clips on the CPU): a missing cache is extracted, then trained;
    ``--extract-only`` writes the cache and trains nothing;
    ``--random-whisper`` with the cache present uses it and extracts nothing."""
    cfg = _synthetic(_config(tmp_path))
    args = ["--config", str(cfg), "--device", "cpu", "--no-wandb", "--layer", "encoder:0"]
    features = tmp_path / "cache" / "features"
    if extra == ["--random-whisper"]:
        _cache(tmp_path)
        monkeypatch.setattr(cli, "extract_and_cache_features",
                            lambda *a, **k: pytest.fail("extraction ran despite the cache"))
    trainers = cli.main(args + extra)
    meta = json.loads((features / "whisper-tiny_encoder_layer0_meta.json").read_text())
    if extra == ["--random-whisper"]:
        assert meta["num_tokens"] == N and meta["hidden_dim"] == D
    else:
        assert meta["num_tokens"] == 2 * 1500 and meta["hidden_dim"] == 384
        assert meta["num_samples"] == 2 and meta["dtype"] == "float32"
        assert meta["data_config"]["dataset_name"] == "synthetic"
        assert not (features / "extraction_progress.json").exists()
    if extra == ["--extract-only"]:
        assert trainers == {} and not (tmp_path / "out").exists()
        return
    (trainer,) = trainers.values()
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    assert len(rows) == -(-meta["num_tokens"] // 256)  # one epoch
    assert np.isfinite([r["loss"] for r in rows]).all()


def test_cli_extracts_and_trains_from_the_librispeech_cache(tmp_path, monkeypatch):
    """``dataset_name: librispeech_asr`` (tiny_default.yaml's) on a mel
    cache ingested beforehand under ``data.cache_dir``: the CLI reads it
    without opening the stream, captures the layer (a small Whisper's, on
    the CPU) and trains on it; the rows are the capture of the cached mels."""
    import librispeech_stream as stream
    from whisper_sae_tpu_torch.config import DataConfig as TDataConfig
    from whisper_sae_tpu_torch.data.librispeech import LibriSpeechDataset
    from whisper_sae_tpu_torch.models import whisper as TW

    arch = TW.WhisperArch(d_model=64, encoder_layers=2, decoder_layers=2, num_heads=1,
                          ffn_dim=128, max_target_positions=8, vocab_size=64,
                          decoder_start_token_id=1, eos_token_id=2)
    params = TW.init_whisper(torch.Generator().manual_seed(0), arch)
    monkeypatch.setattr(cli, "arch_for", lambda name: arch)
    monkeypatch.setattr(cli, "init_whisper", lambda gen, a: params)
    cfg_path = _config(tmp_path, epochs=1)
    cfg = yaml.safe_load(cfg_path.read_text())
    assert cfg["data"]["dataset_name"] == "librispeech_asr"
    cfg["data"]["max_samples"] = 3
    cfg_path.write_text(yaml.safe_dump(cfg))
    samples = stream.sample_stream(3, seed=6)
    monkeypatch.setattr(LibriSpeechDataset, "_load_streaming",
                        lambda self: self._ingest(iter(samples)))
    mels = LibriSpeechDataset(TDataConfig(cache_dir=tmp_path / "cache", max_samples=3),
                              device="cpu")
    monkeypatch.setattr(LibriSpeechDataset, "_load_streaming",
                        lambda self: pytest.fail("streamed although the cache is there"))
    (trainer,) = cli.main(["--config", str(cfg_path), "--device", "cpu", "--no-wandb",
                           "--layer", "encoder:1", "--random-whisper"]).values()
    cache = FeatureCache(tmp_path / "cache" / "features", WhisperConfig(), DataConfig())
    rows, meta = cache.load_rows("encoder", 1)
    assert meta.num_samples == 3 and meta.num_tokens == 3 * 1500 and meta.hidden_dim == 64
    assert meta.data_config["dataset_name"] == "librispeech_asr"
    mel = torch.from_numpy(np.stack([mels[i]["input_features"] for i in range(3)]))
    want = TW.extract_activations(params, mel, arch, compute_dtype=torch.bfloat16,
                                  capture_dtype=torch.bfloat16)["encoder"][1]
    want = want.float().reshape(-1, 64).numpy()
    got = np.asarray(rows, np.float32)
    d = np.abs(got - want)
    assert d.max() <= 2.0**-4 * np.abs(want).max() and d.mean() <= 2.0**-7 * np.abs(want).mean()
    metrics = json.loads((trainer.run_dir / "metrics.json").read_text())
    assert len(metrics) == -(-3 * 1500 // 64) and np.isfinite([m["loss"] for m in metrics]).all()


def test_parse_layer_arg():
    assert cli.parse_layer_arg("decoder:2") == ("decoder", 2)
    with pytest.raises(ValueError):
        cli.parse_layer_arg("middle:1")
