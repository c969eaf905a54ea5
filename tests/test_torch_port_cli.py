"""The port's training CLI (``python -m whisper_sae_tpu_torch.train``) on the
CPU, from a small synthetic cache in the JAX package's format."""

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
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
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


@pytest.mark.parametrize("extra", [[], ["--extract-only"], ["--random-whisper"]])
def test_cli_extraction_not_ported(tmp_path, extra):
    cfg = _config(tmp_path)
    if extra:
        _cache(tmp_path)  # even with a cache, extraction is refused
    with pytest.raises(SystemExit) as exc:
        cli.main(["--config", str(cfg), "--device", "cpu", "--no-wandb", "--layer", "encoder:0",
                  *extra])
    assert "extraction is not ported yet" in str(exc.value.code)


def test_parse_layer_arg():
    assert cli.parse_layer_arg("decoder:2") == ("decoder", 2)
    with pytest.raises(ValueError):
        cli.parse_layer_arg("middle:1")
