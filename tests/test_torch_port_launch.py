"""The port's launcher (``python -m whisper_sae_tpu_torch.launch``) on the
CPU: ``extract --capture-mlp`` into the JAX package's cache format, the
``train-transcoder`` and ``train-crosscoder [--relu]`` jobs with their
files and their resume, run files crossing between the packages, the
ReLU SAE through ``train.main``, and the refusal to run without a card
unless asked for the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from whisper_sae_tpu.config import DataConfig, WhisperConfig
from whisper_sae_tpu.data.feature_cache import FeatureCache as JFeatureCache
from whisper_sae_tpu.models import crosscoder as jxc
from whisper_sae_tpu.models import transcoder as jtc
from whisper_sae_tpu.utils.checkpoint import save_pytree as jsave_pytree
from whisper_sae_tpu_torch import launch
from whisper_sae_tpu_torch import train as cli
from whisper_sae_tpu_torch.models import crosscoder as txc
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models import transcoder as ttc

REPO = Path(__file__).resolve().parent.parent
CLIPS, T, D = 2, 1500, 384
ROWS = CLIPS * T
TRAIN = ["--batch-size", "512", "--expansion-factor", "4", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory) -> Path:
    """``launch extract --capture-mlp`` of 2 synthetic clips, encoder layers
    0 and 1, random weights, on the CPU."""
    root = tmp_path_factory.mktemp("launch")
    out = launch.main(["extract", "--capture-mlp", "--random-whisper", "--dataset", "synthetic",
                       "--max-samples", str(CLIPS), "--batch-size", str(CLIPS),
                       "--layers-encoder", "0,1", "--layers-decoder", "",
                       "--cache-dir", str(root / "cache"), "--device", "cpu"])
    assert out["capture_mlp"] and out["backend"] == "cpu" and out["encoder_layers"] == [0, 1]
    return root / "cache"


def test_extract_writes_pairs_in_the_jax_format(cache_dir):
    jcache = JFeatureCache(cache_dir / "features", WhisperConfig(), DataConfig())
    for comp in ("encoder", "encoder_mlp_in", "encoder_mlp_out"):
        for layer in (0, 1):
            rows, meta = jcache.load_rows(comp, layer)
            assert np.asarray(rows).shape == (ROWS, D) and meta.num_samples == CLIPS
            assert np.isfinite(np.asarray(rows)).all()
    assert not jcache.has_cache("decoder", 0)
    x, _ = jcache.load_rows("encoder_mlp_in", 0)
    y, _ = jcache.load_rows("encoder_mlp_out", 0)
    assert not np.array_equal(np.asarray(x), np.asarray(y))
    features = cache_dir / "features"
    log = json.loads((features / "extraction_log.json").read_text())
    assert log["dataset"] == "synthetic" and log["max_samples"] == CLIPS
    assert json.loads((features / "metadata.json").read_text())["layers"] == {
        "encoder": [0, 1], "decoder": []}
    assert len(json.loads((features / "transcripts.json").read_text())) == CLIPS


@pytest.mark.parametrize("job", ["skip_transcoder", "topk_transcoder", "topk_crosscoder",
                                 "relu_crosscoder"])
def test_training_jobs_write_and_resume(cache_dir, tmp_path, job):
    args = {"skip_transcoder": ["train-transcoder", "--layer-idx", "1"],
            "topk_transcoder": ["train-transcoder", "--layer-idx", "1", "--no-skip"],
            "topk_crosscoder": ["train-crosscoder", "--layers", "0,1"],
            "relu_crosscoder": ["train-crosscoder", "--layers", "0,1", "--relu"]}[job]
    common = TRAIN + ["--cache-dir", str(cache_dir), "--output-dir", str(tmp_path),
                      "--checkpoint-every", "1", "--learning-rate", "1e-3"]
    first = launch.main(args + common + ["--epochs", "1"])
    run = Path(first["run_dir"])
    steps = -(-ROWS // 512)
    kind = "transcoder" if "transcoder" in job else "crosscoder"
    for name in (f"{kind}_final.npz", "metrics.json", "training_config.json", "final.npz",
                 "checkpoint_epoch1.npz"):
        assert (run / name).exists(), name
    assert first["resumed_from"] is None and first["num_tokens"] == ROWS
    second = launch.main(args + common + ["--epochs", "2"])
    assert second["resumed_from"] == "checkpoint_epoch1.npz"
    rows = json.loads((run / "metrics.json").read_text())
    assert [r["step"] for r in rows] == list(range(1, 2 * steps + 1))
    assert np.isfinite([r["loss"] for r in rows]).all()
    assert all((r["sparsity_loss"] > 0) == (job == "relu_crosscoder") for r in rows)
    cfg = json.loads((run / "training_config.json").read_text())
    with np.load(run / f"{kind}_final.npz") as z:
        if kind == "transcoder":
            assert cfg["transcoder"] == {"input_dim": D, "output_dim": D, "hidden_dim": 4 * D,
                                         "k": 32, "use_skip": job == "skip_transcoder"}
            assert ("w_skip" in z.files) == (job == "skip_transcoder")
            model = ttc.load_trained_transcoder(run, device="cpu")
        else:
            assert cfg["crosscoder"]["layer_indices"] == [0, 1]
            assert cfg["crosscoder"]["use_topk"] == (job == "topk_crosscoder")
            assert z["w_enc"].shape == (2, D, 4 * D) and z["w_dec"].shape == (4 * D, 2, D)
            np.testing.assert_allclose(np.linalg.norm(z["w_dec"].reshape(4 * D, -1), axis=1), 1.0,
                                       rtol=1e-5)
            model = txc.load_trained_crosscoder(run, device="cpu")
        for name, value in model.params.items():
            np.testing.assert_array_equal(value.detach().numpy(), z[name])


def test_cache_above_the_resident_limit_raises(cache_dir, tmp_path):
    with pytest.raises(ValueError, match="out-of-core"):
        launch.main(["train-crosscoder", "--layers", "0,1", "--cache-dir", str(cache_dir),
                     "--output-dir", str(tmp_path), "--max-resident-gb", "0.005", *TRAIN])


def _write_run(run_dir: Path, section: str, cfg: dict, params: dict) -> None:
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "training_config.json").write_text(json.dumps({section: cfg}))
    jsave_pytree(run_dir / f"{section}_final.npz", params)


def test_jax_written_runs_load_in_the_port(tmp_path):
    x = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    jt = jtc.create_transcoder(64, 64, 256, k=8, use_skip=True, seed=1)
    jt.params = {**jt.params, "w_dec": jt.params["w_enc"].T * 0.5,
                 "w_skip": jnp.eye(64) * 0.3}
    _write_run(tmp_path / "t", "transcoder",
               {"input_dim": 64, "output_dim": 64, "hidden_dim": 256, "k": 8, "use_skip": True},
               jt.params)
    tt = ttc.load_trained_transcoder(tmp_path / "t", device="cpu")
    assert isinstance(tt, ttc.SkipTranscoder) and not tt.training
    jo = jt.eval()(x, x)
    to = tt(torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(to.predicted.detach().numpy(), np.asarray(jo.predicted),
                               rtol=1e-5, atol=1e-6)
    jc = jxc.create_crosscoder(64, 2, 256, k=8, use_topk=True, layer_indices=[1, 3], seed=2)
    _write_run(tmp_path / "c", "crosscoder",
               {"d_model": 64, "n_layers": 2, "d_sae": 256, "k": 8, "use_topk": True,
                "layer_indices": [1, 3]}, jc.params)
    tc = txc.load_trained_crosscoder(tmp_path / "c", device="cpu")
    assert tc.layer_indices == [1, 3] and tc.k == 8
    acts = {1: x, 3: -x}
    jo = jc.eval()({k: jnp.asarray(v) for k, v in acts.items()})
    to = tc({k: torch.from_numpy(v) for k, v in acts.items()})
    np.testing.assert_allclose(to.loss.detach().numpy(), np.asarray(jo.loss), rtol=1e-5)
    # and the port's files load in the JAX package
    from whisper_sae_tpu_torch.utils.checkpoint import save_pytree

    for run, model, load in ((tmp_path / "t", tt, jtc.load_trained_transcoder),
                             (tmp_path / "c", tc, jxc.load_trained_crosscoder)):
        stem = "transcoder_final" if run.name == "t" else "crosscoder_final"
        save_pytree(run / f"{stem}.npz", model.params)
        back = load(run)
        for k, v in model.params.items():
            np.testing.assert_array_equal(np.asarray(back.params[k]), v.detach().numpy())


def _relu_config(tmp_path: Path) -> Path:
    cfg = yaml.safe_load((REPO / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"].update(activation="relu", expansion_factor=4)
    cfg["training"].update(batch_size=64, learning_rate=3e-3, epochs=2, warmup_steps=5)
    cfg["data"]["cache_dir"] = str(tmp_path / "cache")
    cfg["output_dir"] = str(tmp_path / "out")
    cfg["experiment_name"] = "relu"
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_trains_a_relu_sae(tmp_path):
    rng = np.random.default_rng(3)
    rows = (rng.standard_normal((500, 16)) @ rng.standard_normal((16, 128))).astype(np.float32)
    cache = JFeatureCache(tmp_path / "cache" / "features", WhisperConfig(), DataConfig())
    writer = cache.writer("encoder", 0)
    writer.append(rows)
    writer.finalize(num_samples=1)
    (trainer,) = cli.main(["--config", str(_relu_config(tmp_path)), "--device", "cpu",
                           "--no-wandb", "--layer", "encoder:0"]).values()
    assert isinstance(trainer.model, tsae.ReLUSAE)
    metrics = json.loads((trainer.run_dir / "metrics.json").read_text())
    assert len(metrics) == 2 * 8
    assert all(m["sparsity_loss"] > 0 and m["loss"] > m["reconstruction_loss"] for m in metrics)
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    sae = tsae.load_trained_sae(trainer.run_dir, device="cpu")
    assert isinstance(sae, tsae.ReLUSAE) and sae.hidden_dim == 512
    with np.load(trainer.run_dir / "sae_final.npz") as z:
        assert sorted(z.files) == ["b_dec", "b_enc", "w_dec", "w_enc"]
        np.testing.assert_allclose(np.linalg.norm(z["w_dec"], axis=1), 1.0, rtol=1e-5)
    sd = torch.load(trainer.run_dir / "sae_final.pt")
    assert "b_pre" not in sd and "step_count" not in sd


def test_jobs_need_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["extract", "--dataset", "synthetic", "--random-whisper"],
                 ["train-transcoder", "--cache-dir", str(tmp_path)],
                 ["train-crosscoder", "--cache-dir", str(tmp_path), "--relu"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch.main(argv)
    for build in (lambda: ttc.create_transcoder(32, 32, 128, k=4),
                  lambda: txc.create_crosscoder(32, 2, 128),
                  lambda: tsae.ReLUSAE(32, 128)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_extract_takes_only_the_synthetic_dataset(tmp_path):
    with pytest.raises(ValueError, match="synthetic"):
        launch.main(["extract", "--cache-dir", str(tmp_path), "--device", "cpu"])


def test_parse_layers_and_latest_checkpoint(tmp_path):
    assert launch._parse_layers("0,2,") == [0, 2] and launch._parse_layers("") == []
    assert launch._latest_checkpoint(tmp_path) is None
    for e in (2, 10, 9):
        (tmp_path / f"checkpoint_epoch{e}.npz").write_bytes(b"")
    assert launch._latest_checkpoint(tmp_path).name == "checkpoint_epoch10.npz"
