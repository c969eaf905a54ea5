"""Out-of-core training in the port against the JAX package, on the CPU:
the shard reader and lazy rows over a multi-shard cache, the loader that
streams such a cache, a multi-shard cache trained through the port's CLI
flow (``whisper_sae_tpu_torch.train.main``) and through
``scripts/train.py``'s flow in JAX, and the chunked out-of-core epochs of
``SAETrainer.train`` in both packages, to the same trajectories.

The CLI streams such a cache batch by batch: in both packages ``train``
takes the chunked epochs only for a loader that also exposes ``.data``
or is asked to (``fused=True``), and the shard loader exposes neither,
so the CLI's code under test is the loader's global numpy permutation,
its per-batch gathers from the shards and the bounded resample
subsample.  The chunked epochs' code under test is the epoch's global
numpy permutation, the sorted chunk gathers and the chunks staged in
bf16 under AMP.  The tests pin what the two packages draw differently:
the initial parameters, the order inside a chunk (the same numpy
permutation on both sides, patched into each trainer's
``train_epoch_fused``), a chunk size small enough that an epoch has four
chunks, and a resample period short enough to fire.  Under AMP the JAX
trainer runs its Pallas kernels in interpret mode, as
``tests/test_torch_port_trainer.py`` does.

Tolerances: gathered rows bit for bit; the loss trajectory at rtol 1e-3
under AMP and 2e-4 in f32, final parameters at atol 2e-4 (the bars of
``tests/test_torch_port_trainer.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import DataConfig as JDataConfig
from whisper_sae_tpu.config import WhisperConfig as JWhisperConfig
from whisper_sae_tpu.data.feature_cache import FeatureCache as JFeatureCache
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.ops import pallas_sae
from whisper_sae_tpu.parallel import mesh as jmesh
from whisper_sae_tpu.runtime.shard_reader import ShardReader as JShardReader
from whisper_sae_tpu.training import trainer as jtrainer
from whisper_sae_tpu_torch import train as cli
from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig
from whisper_sae_tpu_torch.data.feature_cache import FeatureCache
from whisper_sae_tpu_torch.data.loader import ActivationLoader
from whisper_sae_tpu_torch.data.shard_reader import PrefetchLoader, ShardReader
from whisper_sae_tpu_torch.models.sae import TopKSAE
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

REPO = Path(__file__).resolve().parent.parent
D, H, K, B = 128, 512, 8, 64
N, SHARD = 1000, 256  # four shards: 256, 256, 256, 232 rows
CHUNK = 4 * B  # four chunks an epoch
EPOCHS, EVERY, RESAMPLE_B = 2, 10, 32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed: int = 0) -> np.ndarray:
    """Rows that a dictionary of 32 directions explains."""
    rng = np.random.default_rng(seed)
    atoms = rng.standard_normal((32, D)).astype(np.float32)
    codes = rng.exponential(1.0, (N, 32)) * (rng.random((N, 32)) < 0.1)
    return (codes @ atoms + 0.05 * rng.standard_normal((N, D))).astype(np.float32)


def _write_cache(root: Path, dtype: str = "float32") -> np.ndarray:
    """A four-shard cache of encoder layer 0, written by the JAX package."""
    rows = _rows()
    cache = JFeatureCache(root / "features", JWhisperConfig(), JDataConfig())
    writer = cache.writer("encoder", 0, shard_tokens=SHARD, dtype=dtype)
    for start in range(0, N, SHARD):  # the writer rolls a shard at an append
        writer.append(rows[start:start + SHARD])
    meta = writer.finalize(num_samples=4)
    assert len(meta.shards) == 4
    return rows


def _bits(a) -> np.ndarray:
    """Rows as comparable bit patterns (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_reader_gathers_like_jax(tmp_path, dtype):
    _write_cache(tmp_path, dtype)
    meta = FeatureCache(tmp_path / "features", WhisperConfig(), DataConfig()).load_metadata(
        "encoder", 0)
    paths = [tmp_path / "features" / s for s in meta.shards]
    port, jax_reader = ShardReader(paths, dtype=dtype), JShardReader(paths, dtype=dtype)
    assert (port.num_rows, port.dim, port.rows_per_shard) == (N, D, [256, 256, 256, 232])
    assert port.row_bytes == D * (2 if dtype == "bfloat16" else 4)
    idx = np.random.default_rng(1).permutation(N)[:300]  # unsorted, every shard
    got = port.gather(idx)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(jax_reader.gather(idx)))


def test_lazy_rows_index_like_an_array(tmp_path):
    rows = _write_cache(tmp_path)
    cache = FeatureCache(tmp_path / "features", WhisperConfig(), DataConfig())
    lazy, meta = cache.load_rows("encoder", 0)
    jlazy, _ = JFeatureCache(tmp_path / "features", JWhisperConfig(),
                             JDataConfig()).load_rows("encoder", 0)
    assert lazy.shape == (N, D) and len(lazy) == N and lazy.nbytes == N * D * 4
    np.testing.assert_array_equal(lazy[250:260].numpy(), rows[250:260])
    np.testing.assert_array_equal(lazy[-1].numpy(), rows[-1])
    idx = np.array([999, 0, 511, 255, 256])
    np.testing.assert_array_equal(lazy[idx].numpy(), rows[idx])
    np.testing.assert_array_equal(lazy[torch.from_numpy(idx)].numpy(), rows[idx])
    np.testing.assert_allclose(lazy.mean0(chunk_rows=300).numpy(),
                               np.asarray(jlazy.mean0()), rtol=1e-5, atol=1e-6)
    with pytest.raises(IndexError):
        lazy[np.array([N])]
    # a single-shard cache comes back whole
    one = FeatureCache(tmp_path / "one", WhisperConfig(), DataConfig())
    w = one.writer("encoder", 0)
    w.append(rows)
    w.finalize(num_samples=4)
    whole, _ = one.load_rows("encoder", 0)
    assert isinstance(whole, torch.Tensor) and whole.shape == (N, D)


def test_get_dataloader_streams_a_multi_shard_cache(tmp_path):
    rows = _write_cache(tmp_path)
    cache = FeatureCache(tmp_path / "features", WhisperConfig(), DataConfig())
    loader = cache.get_dataloader("encoder", 0, batch_size=B, seed=3)
    assert isinstance(loader, PrefetchLoader) and not hasattr(loader, "data")
    assert len(loader) == -(-N // B) and loader.num_tokens == N
    seen = torch.cat(list(loader))
    assert seen.shape == (N, D)
    np.testing.assert_array_equal(np.sort(seen.numpy(), axis=0), np.sort(rows, axis=0))
    whole = cache.get_dataloader("encoder", 0, batch_size=B, out_of_core=False)
    assert isinstance(whole, ActivationLoader)
    np.testing.assert_array_equal(np.asarray(whole.data), rows)


def _config(tmp_path: Path, amp: bool) -> Path:
    cfg = yaml.safe_load((REPO / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"].update(expansion_factor=H // D, k=K, dead_feature_threshold=3)
    cfg["training"].update(batch_size=B, learning_rate=1e-3, epochs=EPOCHS, warmup_steps=2,
                           use_amp=amp, seed=3)
    cfg["data"]["cache_dir"] = str(tmp_path / "cache")
    cfg["output_dir"] = str(tmp_path / "out")
    cfg["experiment_name"] = "ooc"
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _params() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(1)
    bound = 1 / np.sqrt(D)
    w_dec = rng.standard_normal((H, D))
    return {
        "w_enc": rng.uniform(-bound, bound, (D, H)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, H).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": np.zeros(D, np.float32),
        "b_pre": np.zeros(D, np.float32),
    }


def _pinned(base, log: list):
    """``base`` with the resample period and set size of this test, the
    chunk size pinned, and the order inside each chunk drawn from numpy
    by the step the chunk starts at (the same on both sides)."""

    class Pinned(base):
        def __init__(self, *a, **kw):
            kw.update(resample_dead_every=EVERY, resample_batch_size=RESAMPLE_B)
            super().__init__(*a, **kw)
            log.append(self)

        def train_epoch_out_of_core(self, reader, chunk_tokens=1 << 22, seed=None):
            return super().train_epoch_out_of_core(reader, chunk_tokens=CHUNK, seed=seed)

        def train_epoch_fused(self, data, shuffle=True, seed=None, perm=None, **kw):
            first = data[0] if isinstance(data, tuple) else data
            n = first.shape[0]
            self.chunk_rows = getattr(self, "chunk_rows", []) + [n]
            perm = np.random.default_rng(self.global_step).permutation(n)
            return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, perm=perm, **kw)

    return Pinned


def _run_jax_cli(cfg: Path, monkeypatch, amp: bool):
    log: list = []
    params = _params()
    monkeypatch.setattr(jtrainer, "SAETrainer", _pinned(jtrainer.SAETrainer, log))
    monkeypatch.setattr(jsae, "create_sae", lambda c, input_dim, seed=0: jsae.TopKSAE(
        input_dim, c.get_hidden_dim(input_dim), c.k, normalize_decoder=c.normalize_decoder,
        dead_feature_threshold=c.dead_feature_threshold,
        params={k: jnp.asarray(v) for k, v in params.items()}))
    monkeypatch.setattr(jmesh, "mesh_from_config", lambda *a: (_ for _ in ()).throw(
        RuntimeError("single device")))
    if amp:  # the windowed Pallas epoch, in interpret mode, as on the TPU
        monkeypatch.setattr(pallas_sae, "fused_loss_supported", lambda *a: True)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", str(cfg), "--no-wandb",
                                      "--layer", "encoder:0", "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("_jax_train_cli", REPO / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pltpu.force_tpu_interpret_mode():
        mod.main()
    (trainer,) = log
    return trainer


def _run_port_cli(cfg: Path, monkeypatch):
    log: list = []
    params = params_from_jax(_params())
    monkeypatch.setattr(cli, "SAETrainer", _pinned(cli.SAETrainer, log))
    real = cli.create_sae

    def create(c, input_dim, seed=0, device=None):
        sae = real(c, input_dim, seed=seed, device=device)
        assert isinstance(sae, TopKSAE)
        sae.load_params(params)
        return sae

    monkeypatch.setattr(cli, "create_sae", create)
    (trainer,) = cli.main(["--config", str(cfg), "--no-wandb", "--layer", "encoder:0",
                           "--device", "cpu"]).values()
    assert log == [trainer]
    return trainer


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_out_of_core_cli_matches_jax(tmp_path, monkeypatch, amp):
    _write_cache(tmp_path / "cache")
    cfg = _config(tmp_path, amp)
    jt = _run_jax_cli(cfg, monkeypatch, amp)
    jdir = tmp_path / "jax_out"
    (tmp_path / "out").rename(jdir)
    tt = _run_port_cli(cfg, monkeypatch)

    # streamed batch by batch on both sides: no fused chunk
    assert not hasattr(tt, "chunk_rows") and not hasattr(jt, "chunk_rows")
    steps = EPOCHS * -(-N // B)
    assert tt.global_step == jt.global_step == steps
    # the bounded resample set: 8 resample batches of sorted rows
    assert len(tt._resample_dataset) == 8 * RESAMPLE_B
    np.testing.assert_array_equal(tt._resample_dataset.numpy(), np.asarray(jt._resample_dataset))
    assert tt.num_resampled_total == jt.num_resampled_total > 0
    _same_run(tmp_path / "out", jdir, steps, amp)


def _same_run(out: Path, jout: Path, steps: int, amp: bool, run: str = "ooc_encoder_layer0",
              final: str = "sae_final.npz") -> None:
    tl = [r["loss"] for r in json.loads((out / run / "metrics.json").read_text())]
    jl = [r["loss"] for r in json.loads((jout / run / "metrics.json").read_text())]
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if amp else 2e-4)
    with np.load(out / run / final) as z, np.load(jout / run / final) as zj:
        assert sorted(z.files) == sorted(zj.files)
        for k in z.files:
            np.testing.assert_allclose(z[k], zj[k], atol=2e-4)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_chunked_out_of_core_train_matches_jax(tmp_path, monkeypatch, amp):
    """``train(loader, fused=True)`` over the four-shard cache: four
    chunks an epoch, each gathered sorted from the epoch's permutation,
    staged in bf16 under AMP, trained as one fused epoch; the resample
    checked at every chunk boundary."""
    from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
    from whisper_sae_tpu_torch.config import TrainingConfig

    _write_cache(tmp_path)
    kw = dict(batch_size=B, learning_rate=1e-3, epochs=EPOCHS, warmup_steps=2, use_amp=amp,
              seed=3)
    jlog, tlog = [], []
    jcache = JFeatureCache(tmp_path / "features", JWhisperConfig(), JDataConfig())
    jloader = jcache.get_dataloader("encoder", 0, batch_size=B, seed=3)
    p = _params()
    jt = _pinned(jtrainer.SAETrainer, jlog)(
        jsae.TopKSAE(D, H, K, dead_feature_threshold=3,
                     params={k: jnp.asarray(v) for k, v in p.items()}),
        JTrainingConfig(**kw), run_dir=tmp_path / "jax" / "run")
    if amp:
        monkeypatch.setattr(pallas_sae, "fused_loss_supported", lambda *a: True)
    idx = np.sort(np.random.default_rng(3).permutation(N)[:8 * RESAMPLE_B])
    jt.set_resample_dataset(jloader.reader.gather(idx))
    with pltpu.force_tpu_interpret_mode():
        jt.train(jloader, fused=True)
    jt.save_final()
    jt.save_metrics()

    loader = FeatureCache(tmp_path / "features", WhisperConfig(),
                          DataConfig()).get_dataloader("encoder", 0, batch_size=B, seed=3)
    tt = _pinned(SAETrainer, tlog)(
        TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(p), device="cpu"),
        TrainingConfig(**kw), run_dir=tmp_path / "port" / "run")
    tt.set_resample_dataset(loader.reader.gather(idx))
    tt.train(loader, fused=True)
    tt.save_final()
    tt.save_metrics()

    assert tt.chunk_rows == jt.chunk_rows == [256, 256, 256, 232] * EPOCHS
    steps = EPOCHS * (3 * 4 + 3 + 1)
    assert tt.global_step == jt.global_step == steps and tt.epoch == jt.epoch == EPOCHS
    assert tt.num_resampled_total == jt.num_resampled_total > 0
    _same_run(tmp_path / "port", tmp_path / "jax", steps, amp, run="run")


def test_out_of_core_epoch_draws_the_jax_order(tmp_path):
    """``train_epoch_out_of_core`` gathers the slices of
    ``default_rng(seed + epoch).permutation(n)``, each sorted."""
    _write_cache(tmp_path)
    reader = FeatureCache(tmp_path / "features", WhisperConfig(),
                          DataConfig()).get_dataloader("encoder", 0, B).reader
    gathered = []

    class Spy:
        num_rows, row_bytes = reader.num_rows, reader.row_bytes

        @staticmethod
        def gather(idx):
            gathered.append(np.asarray(idx))
            return reader.gather(idx)

    from whisper_sae_tpu_torch.config import TrainingConfig

    sae = TopKSAE(D, H, K, params=params_from_jax(_params()), device="cpu")
    trainer = SAETrainer(sae, TrainingConfig(batch_size=B, seed=5, warmup_steps=1),
                         run_dir=tmp_path / "run")
    trainer.setup_scheduler(100)
    trainer.epoch = 1
    metrics = trainer.train_epoch_out_of_core(Spy(), chunk_tokens=300)  # 4 batches a chunk
    order = np.random.default_rng(5 + 1).permutation(N)
    want = [np.sort(order[s:s + 256]) for s in range(0, N, 256)]
    assert len(gathered) == len(want)
    for got, w in zip(gathered, want):
        np.testing.assert_array_equal(got, w)
    assert trainer.epoch == 2 and len(metrics) == 3 * 4 + 3 + 1
