"""The port's launcher (``python -m whisper_sae_tpu_torch.launch``) on the
CPU: ``extract --capture-mlp`` into the JAX package's cache format, the
``train-transcoder`` and ``train-crosscoder [--relu]`` jobs with their
files and their resume, run files crossing between the packages, the
ReLU SAE through ``train.main``, and the refusal to run without a card
unless asked for the CPU."""

from __future__ import annotations

import importlib.util
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


def test_cache_above_the_resident_limit_raises(cache_dir, tmp_path, monkeypatch):
    """A crosscoder whose caches exceed ``--max-resident-gb`` no longer
    raises (the name is the one the check had when it did): it streams
    batch by batch through the multi-layer loader, as the JAX launcher's
    does (its loader has no ``.data``, so ``train`` steps through it), and
    trains every batch.  Its trajectory is held against the JAX launcher's
    by ``test_crosscoder_above_the_resident_limit_streams_like_jax``."""
    loaders = []
    real = launch.MultiLayerLoader

    def spy(*a, **kw):
        loaders.append(real(*a, **kw))
        return loaders[-1]

    monkeypatch.setattr(launch, "MultiLayerLoader", spy)
    out = launch.main(["train-crosscoder", "--layers", "0,1", "--cache-dir", str(cache_dir),
                       "--output-dir", str(tmp_path), "--max-resident-gb", "0.005",
                       "--epochs", "1", *TRAIN])
    (loader,) = loaders
    assert loader.num_tokens == ROWS and not hasattr(loader, "data")
    assert out["num_tokens"] == ROWS and np.isfinite(out["final_loss"])
    rows = json.loads((Path(out["run_dir"]) / "metrics.json").read_text())
    assert len(rows) == -(-ROWS // 512)
    assert np.isfinite([r["loss"] for r in rows]).all()


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streamed"])
@pytest.mark.parametrize("job", ["transcoder", "crosscoder"])
def test_training_jobs_read_each_cache_once(cache_dir, tmp_path, monkeypatch, job, resident):
    """Residency is decided from the metadata: a resident cache is read
    whole once (``load``); a streamed one goes through ``load_rows``,
    which reads a single shard whole, once, and opens more lazily."""
    calls = []
    cls = launch.FeatureCache
    for name in ("load", "load_rows"):
        real = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, c, i, _r=real, _n=name:
                            calls.append((_n, c, i)) or _r(self, c, i))
    args = (["train-transcoder", "--layer-idx", "1"] if job == "transcoder"
            else ["train-crosscoder", "--layers", "0,1"])
    launch.main(args + TRAIN + ["--cache-dir", str(cache_dir), "--output-dir", str(tmp_path),
                                "--epochs", "1", "--max-resident-gb",
                                "1" if resident else "0.005"])
    keys = ([("encoder_mlp_in", 1), ("encoder_mlp_out", 1)] if job == "transcoder"
            else [("encoder", 0), ("encoder", 1)])
    assert [c[1:] for c in calls if c[0] == "load"] == keys  # one shard each: read once
    assert [c[1:] for c in calls if c[0] == "load_rows"] == ([] if resident else keys)


def _jax_launcher():
    spec = importlib.util.spec_from_file_location("_jax_launcher", REPO / "launcher" / "launch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pinned_transcoder_trainer(base, log: list, chunk: int):
    """The chunk size pinned, and the order inside each chunk drawn from
    numpy by the step it starts at, the same on both sides."""

    class Pinned(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            log.append(self)

        def train_epoch_out_of_core(self, reader, chunk_tokens=1 << 22, seed=None):
            return super().train_epoch_out_of_core(reader, chunk_tokens=chunk, seed=seed)

        def train_epoch_fused(self, data, shuffle=True, seed=None, perm=None, **kw):
            n = data[0].shape[0]
            self.chunk_rows = getattr(self, "chunk_rows", []) + [n]
            perm = np.random.default_rng(self.global_step).permutation(n)
            return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, perm=perm, **kw)

    return Pinned


def test_transcoder_above_the_resident_limit_streams_like_jax(cache_dir, tmp_path,
                                                             monkeypatch):
    """``train-transcoder`` above ``--max-resident-gb`` streams chunked
    epochs through the paired reader, with a bounded resample subsample,
    and follows the JAX launcher's trajectory (f32, the same initial
    parameters, chunks of 1,024 rows, the same order inside a chunk):
    losses at rtol 2e-4, final parameters at atol 2e-4 on >= 99.99% of
    elements (f32 products summed in another order can flip a latent at
    the top-k threshold in one step, which moves that feature's weights:
    measured 5 of 589,824 encoder weights off by up to 7.3e-4)."""
    from whisper_sae_tpu.training import coder_trainers as jct

    from whisper_sae_tpu_torch.training import coder_trainers as tct

    chunk, epochs = 1024, 2
    init = {k: np.asarray(v) for k, v in jtc.create_transcoder(D, D, 4 * D, k=32, use_skip=True,
                                                                 seed=0).params.items()}
    jlog, tlog = [], []
    real_j, real_t = jtc.create_transcoder, ttc.create_transcoder

    def jcreate(*a, **kw):
        m = real_j(*a, **kw)
        m.params = {k: jnp.asarray(v) for k, v in init.items()}
        return m

    def tcreate(*a, **kw):
        m = real_t(*a, **kw)
        m.load_params(init)
        return m

    monkeypatch.setattr(jtc, "create_transcoder", jcreate)
    monkeypatch.setattr(jct, "TranscoderTrainer",
                        _pinned_transcoder_trainer(jct.TranscoderTrainer, jlog, chunk))
    monkeypatch.setattr(launch, "create_transcoder", tcreate)
    monkeypatch.setattr(launch, "TranscoderTrainer",
                        _pinned_transcoder_trainer(tct.TranscoderTrainer, tlog, chunk))
    kw = dict(component="encoder", layer_idx=1, expansion_factor=4, k=32, use_skip=True,
              batch_size=512, learning_rate=1e-3, epochs=epochs, warmup_steps=2, use_amp=False,
              cache_dir=cache_dir, max_resident_bytes=1 << 20)
    jres = _jax_launcher().train_transcoder(output_dir=tmp_path / "jax", **kw)
    tres = launch.train_transcoder(output_dir=tmp_path / "port", device="cpu", **kw)
    (jt,), (tt,) = jlog, tlog
    assert tt.chunk_rows == jt.chunk_rows == [1024, 1024, 952] * epochs
    assert tt.global_step == jt.global_step == epochs * 6
    x_resample = tt._resample_dataset[0]
    assert len(x_resample) == min(ROWS, 8 * tt.resample_batch_size)
    np.testing.assert_array_equal(x_resample.numpy(), np.asarray(jt._resample_dataset[0]))
    tl = [r["loss"] for r in json.loads((Path(tres["run_dir"]) / "metrics.json").read_text())]
    jl = [r["loss"] for r in json.loads((Path(jres["run_dir"]) / "metrics.json").read_text())]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    with np.load(Path(tres["run_dir"]) / "transcoder_final.npz") as z, \
            np.load(Path(jres["run_dir"]) / "transcoder_final.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
        for k in z.files:
            close = np.isclose(z[k], zj[k], rtol=0, atol=2e-4)
            assert close.mean() >= 0.9999, (k, close.mean())


@pytest.mark.parametrize("use_topk", [True, False], ids=["topk", "relu"])
def test_crosscoder_above_the_resident_limit_streams_like_jax(cache_dir, tmp_path, monkeypatch,
                                                              use_topk):
    """``train-crosscoder`` above ``--max-resident-gb`` steps through the
    multi-layer loader's sorted per-batch gathers and follows the JAX
    launcher's trajectory: f32, the same initial parameters, the same
    numpy order; losses at rtol 2e-4, as the transcoder's."""
    init = {k: np.asarray(v) for k, v in jxc.create_crosscoder(
        D, 2, 4 * D, k=32, use_topk=use_topk, layer_indices=[0, 1], seed=0).params.items()}
    real_j, real_t = jxc.create_crosscoder, txc.create_crosscoder

    def jcreate(*a, **kw):
        m = real_j(*a, **kw)
        m.params = {k: jnp.asarray(v) for k, v in init.items()}
        return m

    def tcreate(*a, **kw):
        m = real_t(*a, **kw)
        m.load_params(init)
        return m

    monkeypatch.setattr(jxc, "create_crosscoder", jcreate)
    monkeypatch.setattr(launch, "create_crosscoder", tcreate)
    kw = dict(component="encoder", layers="0,1", expansion_factor=4, k=32, use_topk=use_topk,
              batch_size=512, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=False,
              cache_dir=cache_dir, max_resident_bytes=1 << 20)
    jres = _jax_launcher().train_crosscoder(output_dir=tmp_path / "jax", **kw)
    tres = launch.train_crosscoder(output_dir=tmp_path / "port", device="cpu", **kw)
    assert tres["num_tokens"] == jres["num_tokens"] == ROWS
    tl = [r["loss"] for r in json.loads((Path(tres["run_dir"]) / "metrics.json").read_text())]
    jl = [r["loss"] for r in json.loads((Path(jres["run_dir"]) / "metrics.json").read_text())]
    assert len(tl) == len(jl) == 2 * -(-ROWS // 512)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)


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


# ---------------------------------------------------------------------------
# the real-audio route: LibriSpeech's mel cache
# ---------------------------------------------------------------------------

SMALL = dict(d_model=64, encoder_layers=2, decoder_layers=2, num_heads=1, ffn_dim=128,
             max_source_positions=1500, max_target_positions=448, vocab_size=64,
             decoder_start_token_id=1, eos_token_id=2)
LS_SAMPLES, LS_BAD = 4, (1,)  # 3 clips decode
STACK_MAX, STACK_MEAN = 2.0**-4, 2.0**-7


@pytest.fixture(scope="module")
def jlaunch():
    spec = importlib.util.spec_from_file_location("_jax_launcher", REPO / "launcher" / "launch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_params():
    """A small Whisper's random weights (the JAX launcher's draw at seed
    42) in both packages' layouts."""
    import jax

    from whisper_sae_tpu.models import whisper as JW
    from whisper_sae_tpu_torch.models import whisper as TW

    jparams = JW.init_whisper(jax.random.PRNGKey(42), JW.WhisperArch(**SMALL))
    return jparams, TW.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _small_whisper(monkeypatch, tparams) -> None:
    """Both launchers build the small arch; the port's gets the JAX draw."""
    from whisper_sae_tpu.models import whisper as JW
    from whisper_sae_tpu_torch.models import whisper as TW

    monkeypatch.setattr(JW, "arch_for", lambda name: JW.WhisperArch(**SMALL))
    monkeypatch.setattr(launch, "arch_for", lambda name: TW.WhisperArch(**SMALL))
    monkeypatch.setattr(launch, "init_whisper", lambda gen, arch: tparams)


def _ingest_stream(cache_dir: Path, n: int, bad=(), seed: int = 25) -> None:
    """The JAX package ingests a local sample stream into ``cache_dir``
    (the mel cache both launchers read)."""
    import librispeech_stream as stream
    from whisper_sae_tpu.data.librispeech import LibriSpeechDataset as JLibriSpeech

    samples = stream.sample_stream(n, seed=seed, bad=bad)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JLibriSpeech, "_load_streaming", lambda self: self._ingest(iter(samples)))
        JLibriSpeech(DataConfig(cache_dir=cache_dir, max_samples=n))
    finally:
        mp.undo()


def _no_streaming(monkeypatch) -> None:
    from whisper_sae_tpu.data.librispeech import LibriSpeechDataset as JLibriSpeech
    from whisper_sae_tpu_torch.data.librispeech import LibriSpeechDataset

    for cls in (JLibriSpeech, LibriSpeechDataset):
        monkeypatch.setattr(cls, "_load_streaming",
                            lambda self: pytest.fail("streamed although the cache is there"))


def _stack_bar(got: np.ndarray, want: np.ndarray, what: str) -> None:
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    ref = np.abs(want.astype(np.float32))
    assert d.max() <= STACK_MAX * ref.max() and d.mean() <= STACK_MEAN * ref.mean(), what


def test_extract_reads_the_librispeech_cache_as_jax_does(tmp_path, monkeypatch, jlaunch,
                                                        small_params):
    """``extract --dataset librispeech_asr`` on a mel cache the JAX package
    ingested: the same feature caches (bf16 capture at the stack bar),
    transcripts, extraction log and metadata as the JAX launcher's from
    the same cache and weights; the stream is never opened."""
    import shutil

    jparams, tparams = small_params
    _ingest_stream(tmp_path / "mels", LS_SAMPLES, LS_BAD)
    for d in ("jax", "port"):
        shutil.copytree(tmp_path / "mels", tmp_path / d)
    _small_whisper(monkeypatch, tparams)
    _no_streaming(monkeypatch)
    kw = dict(layers_encoder="0,1", layers_decoder="1", max_samples=LS_SAMPLES, batch_size=2,
              dataset="librispeech_asr", random_whisper=True)
    want = jlaunch.extract_features(cache_dir=tmp_path / "jax", use_mesh=False, **kw)
    got = launch.main(["extract", "--dataset", "librispeech_asr", "--max-samples",
                       str(LS_SAMPLES), "--batch-size", "2", "--layers-encoder", "0,1",
                       "--layers-decoder", "1", "--cache-dir", str(tmp_path / "port"),
                       "--random-whisper", "--device", "cpu"])
    volatile = ("elapsed_s", "finished_at", "backend")
    assert {k: v for k, v in got.items() if k not in volatile} == \
        {k: v for k, v in want.items() if k not in volatile}
    assert got["dataset"] == "librispeech_asr"
    jf, tf = tmp_path / "jax" / "features", tmp_path / "port" / "features"
    assert sorted(p.name for p in tf.iterdir()) == sorted(p.name for p in jf.iterdir())
    for name in ("extraction_log.json", "metadata.json"):
        t, j = (json.loads((f / name).read_text()) for f in (tf, jf))
        for key in ("elapsed_s", "finished_at", "backend", "created_at"):
            t.pop(key, None), j.pop(key, None)
        assert t == j, name
    assert (tf / "transcripts.json").read_text() == (jf / "transcripts.json").read_text()
    transcripts = json.loads((tf / "transcripts.json").read_text())
    assert len(transcripts) == LS_SAMPLES - len(LS_BAD)
    jcache = JFeatureCache(jf, WhisperConfig(), DataConfig())
    tcache = JFeatureCache(tf, WhisperConfig(), DataConfig())
    for comp, layer, tokens in (("encoder", 0, 1500), ("encoder", 1, 1500), ("decoder", 1, 1)):
        (trows, tmeta), (jrows, jmeta) = tcache.load_rows(comp, layer), jcache.load_rows(comp, layer)
        assert tmeta.num_samples == jmeta.num_samples == LS_SAMPLES - len(LS_BAD)
        assert tmeta.num_tokens == jmeta.num_tokens == 3 * tokens
        assert tmeta.data_config["dataset_name"] == "librispeech_asr"
        trows, jrows = np.asarray(trows), np.asarray(jrows)
        assert trows.shape == jrows.shape == (3 * tokens, SMALL["d_model"])
        assert np.isfinite(trows).all()
        _stack_bar(trows, jrows, f"{comp}:{layer}")


def test_extract_without_a_cache_reaches_load_streaming(tmp_path, monkeypatch, small_params):
    """No mel cache: the job calls ``_load_streaming`` (patched to ingest a
    local stream), then extracts from what it wrote."""
    import librispeech_stream as stream
    from whisper_sae_tpu_torch.data.librispeech import LibriSpeechDataset

    _small_whisper(monkeypatch, small_params[1])
    samples = stream.sample_stream(2, seed=4)
    calls = []

    def ingest_local(self):
        calls.append(self._stem)
        self._ingest(iter(samples))

    monkeypatch.setattr(LibriSpeechDataset, "_load_streaming", ingest_local)
    out = launch.main(["extract", "--dataset", "librispeech_asr", "--max-samples", "2",
                       "--layers-encoder", "1", "--layers-decoder", "", "--cache-dir",
                       str(tmp_path), "--random-whisper", "--device", "cpu"])
    assert calls == ["librispeech_clean_train.100_2"] and out["dataset"] == "librispeech_asr"
    assert (tmp_path / "librispeech_clean_train.100_2_shard00000.npy").exists()
    meta = JFeatureCache(tmp_path / "features", WhisperConfig(), DataConfig()).load_metadata(
        "encoder", 1)
    assert meta.num_samples == 2 and meta.num_tokens == 3000
    assert json.loads((tmp_path / "features" / "transcripts.json").read_text()) == {
        "0": samples[0]["text"], "1": samples[1]["text"]}


def test_causal_validate_replays_a_librispeech_extraction_as_jax_does(tmp_path, monkeypatch,
                                                                      jlaunch, small_params):
    """An extraction log whose dataset is not synthetic: both jobs read the
    mel cache under the default ``cache/`` (the working directory's) with
    the stem of ``num_samples`` -- the JAX job's ``DataConfig`` -- and agree
    at the causal bars (KL within 1e-4 relative, token agreement equal)."""
    from whisper_sae_tpu.models import sae as jsae

    jparams, tparams = small_params
    monkeypatch.chdir(tmp_path)
    _ingest_stream(Path("cache"), 2, seed=31)  # librispeech_clean_train.100_2
    elog = tmp_path / "elog"
    (elog / "features").mkdir(parents=True)
    (elog / "features" / "extraction_log.json").write_text(json.dumps(
        {"dataset": "librispeech_asr", "seed": 42, "max_samples": 4}))
    runs = {}
    for side in ("jax", "port"):
        run = tmp_path / side / "launch_encoder_layer1"
        run.mkdir(parents=True)
        jsave_pytree(run / "sae_final.npz", {k: np.asarray(v) for k, v in jsae.TopKSAE(
            SMALL["d_model"], 256, 8, seed=1).params.items()})
        (run / "training_config.json").write_text(json.dumps(
            {"sae": {"expansion_factor": 4, "k": 8}, "component": "encoder", "layer_idx": 1}))
        runs[side] = tmp_path / side
    _small_whisper(monkeypatch, tparams)
    _no_streaming(monkeypatch)
    kw = dict(component="encoder", layer_idx=1, num_samples=2, sweep_features=2, cache_dir=elog,
              random_whisper=True)
    want = jlaunch.causal_validate(output_dir=runs["jax"], **kw)
    got = launch.causal_validate(output_dir=runs["port"], device="cpu", **kw)
    for key in ("component", "layer_idx", "num_samples", "token_agreement"):
        assert got[key] == want[key], key
    assert abs(got["logit_kl"] - want["logit_kl"]) <= 1e-4 * abs(want["logit_kl"])
    assert [r["feature_idx"] for r in got["ablation_sweep"]] == \
        [r["feature_idx"] for r in want["ablation_sweep"]]
    for g, w in zip(got["ablation_sweep"], want["ablation_sweep"]):
        assert abs(g["logit_kl"] - w["logit_kl"]) <= 1e-4 * abs(w["logit_kl"]) + 1e-9


def test_parse_layers_and_latest_checkpoint(tmp_path):
    assert launch._parse_layers("0,2,") == [0, 2] and launch._parse_layers("") == []
    assert launch._latest_checkpoint(tmp_path) is None
    for e in (2, 10, 9):
        (tmp_path / f"checkpoint_epoch{e}.npz").write_bytes(b"")
    assert launch._latest_checkpoint(tmp_path).name == "checkpoint_epoch10.npz"
