"""dp extraction and the CLI under torchrun's environment, on the CPU: the
port's ranks (gloo processes, ``tests/torch_parallel_ranks.py``) against
the single-process port and against the JAX package on a mesh of the same
data axis (``jax.devices()[:2]``).

- Extraction: 5 synthetic clips in batches of 3 (a batch that does not
  split over two data ranks: padded with its last row, as JAX pads it)
  over a ``(2, 1)`` mesh and over a ``(2, 2)`` mesh (the model ranks of a
  data row capture the same rows), MLP pairs included, f32 and bf16:
  the files, metadata and rows of the single-process port's cache, bit
  for bit in bf16 (in f32 at rtol/atol 1e-6: the CPU's f32 products of
  the one-token decoder are summed in an order set by the row count); against JAX ``extract_and_cache_features(mesh=...)`` at the
  bars of ``tests/test_torch_port_extract.py`` (f32 rtol/atol 1e-4, bf16
  the stack bar).
- The CLI: ``whisper_sae_tpu_torch.train.main`` in two ranks whose
  environment is torchrun's (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``),
  from a JAX-written cache, against ``scripts/train.py`` on a 2-device JAX
  mesh, both with the same initial parameters and epoch orders pinned:
  ``metrics.json`` at rtol 2e-4, ``sae_final.npz`` at atol 2e-4; only rank
  0 writes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_ranks as ranks
from whisper_sae_tpu.config import DataConfig as JDataConfig
from whisper_sae_tpu.config import WhisperConfig as JWhisperConfig
from whisper_sae_tpu.data import feature_cache as jfc
from whisper_sae_tpu.data import librispeech as jls
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.parallel import mesh as jmesh
from whisper_sae_tpu.training import trainer as jtrainer
from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig
from whisper_sae_tpu_torch.data import feature_cache as tfc
from whisper_sae_tpu_torch.data import librispeech as tls
from whisper_sae_tpu_torch.models import whisper as TW

REPO = Path(__file__).resolve().parent.parent
ARCH = dict(d_model=64, encoder_layers=2, decoder_layers=2, num_heads=1, ffn_dim=128,
            max_source_positions=1500, max_target_positions=8, vocab_size=64,
            decoder_start_token_id=1, eos_token_id=2)
CLIPS, BATCH = 5, 3
STACK_MAX, STACK_MEAN = 2.0**-4, 2.0**-7
LAYERS = [("encoder", 1), ("decoder", 0), ("decoder", 1), ("encoder_mlp_in", 1),
          ("encoder_mlp_out", 1), ("decoder_mlp_out", 0)]
D_CLI, N_CLI, B_CLI = 32, 1001, 64  # 15 steps an epoch and a 41-row remainder


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _whisper():
    params = JW.init_whisper(jax.random.PRNGKey(0), JW.WhisperArch(**ARCH))
    key = jax.random.PRNGKey(1)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * jax.random.normal(key, a.shape), params)
    return jax.tree_util.tree_map(np.asarray, params)


def _cli_config(root: Path, out: str) -> Path:
    cfg = yaml.safe_load((REPO / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"].update(expansion_factor=4, k=8)
    cfg["training"].update(batch_size=B_CLI, learning_rate=3e-3, epochs=2, warmup_steps=3,
                           use_amp=False, seed=3)
    cfg["data"]["cache_dir"] = str(root / "cache")
    cfg["output_dir"] = str(root / out)
    cfg["experiment_name"] = "mesh"
    path = root / f"{out}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _cli_params() -> dict:
    rng = np.random.default_rng(11)
    h = 4 * D_CLI
    w_dec = rng.standard_normal((h, D_CLI))
    return {"w_enc": rng.uniform(-0.2, 0.2, (D_CLI, h)).astype(np.float32),
            "b_enc": rng.uniform(-0.2, 0.2, h).astype(np.float32),
            "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
            "b_dec": np.zeros(D_CLI, np.float32), "b_pre": np.zeros(D_CLI, np.float32)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The extraction groups ((2, 1) in f32 and bf16, (2, 2) in bf16) and
    the two-rank CLI, started together."""
    root = tmp_path_factory.mktemp("parallel_extract")
    params = _whisper()
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((N_CLI, D_CLI)).astype(np.float32)
    cache = jfc.FeatureCache(root / "cli" / "cache" / "features", JWhisperConfig(), JDataConfig())
    writer = cache.writer("encoder", 0)
    writer.append(rows)
    writer.finalize(num_samples=1)
    argv = ["--config", str(_cli_config(root / "cli", "port")), "--device", "cpu", "--no-wandb",
            "--layer", "encoder:0"]
    env = {"WORLD_SIZE": "2", "RANK": "{rank}", "LOCAL_RANK": "{rank}", "LOCAL_WORLD_SIZE": "2"}
    groups = [(2, "extract", root / "f32", dict(params=params, arch=ARCH, clips=CLIPS, batch=BATCH,
                                                compute="f32", out="mesh", data_mesh=2)),
              (2, "extract", root / "bf16", dict(params=params, arch=ARCH, clips=CLIPS,
                                                 batch=BATCH, compute="bf16", out="mesh",
                                                 data_mesh=2)),
              (4, "extract", root / "bf16x2", dict(params=params, arch=ARCH, clips=CLIPS,
                                                   batch=BATCH, compute="bf16", out="mesh",
                                                   data_mesh=2)),
              (2, "cli", root / "cli", dict(argv=argv, params=_cli_params(), env=env)),
              (2, "launch_jobs", root / "launch", dict(argvs=_launch_argvs(root / "launch" / "mesh"),
                                                      env=env))]
    f32, bf16, bf16x2, cli, jobs = ranks.spawn_groups(groups)
    return dict(root=root, params=params, f32=f32, bf16=bf16, bf16x2=bf16x2, cli=cli, jobs=jobs)


def _launch_argvs(root: Path) -> list:
    """``launch extract`` (2 whisper-tiny clips, MLP pairs, bf16) and
    ``launch train-transcoder`` on its cache (one AMP epoch of 6 steps)."""
    cache = ["--cache-dir", str(root / "cache"), "--device", "cpu"]
    return [["extract", "--capture-mlp", "--random-whisper", "--dataset", "synthetic",
             "--max-samples", "2", "--batch-size", "2", "--layers-encoder", "0",
             "--layers-decoder", "", *cache],
            ["train-transcoder", "--layer-idx", "0", "--batch-size", "512", "--epochs", "1",
             "--expansion-factor", "4", "--learning-rate", "1e-3", "--output-dir",
             str(root / "out"), *cache]]


def _single_port(root: Path, params, compute: str) -> tfc.FeatureCache:
    cache = tfc.FeatureCache(root / "single", WhisperConfig(),
                             DataConfig(dataset_name="synthetic", max_samples=CLIPS))
    loader = tls.AudioBatchLoader(
        tls.LibriSpeechFeaturesOnly(tls.SyntheticSpeechDataset(CLIPS, seed=3)), batch_size=BATCH)
    tfc.extract_and_cache_features(
        TW.params_from_jax(params), TW.WhisperArch(**ARCH), loader, cache, encoder_layers=[1],
        decoder_layers=[0, 1], max_samples=CLIPS, progress=False, capture_mlp=True,
        compute_dtype=torch.bfloat16 if compute == "bf16" else None)
    return cache


def _jax_mesh_cache(root: Path, params, compute: str) -> jfc.FeatureCache:
    cache = jfc.FeatureCache(root / "jax", JWhisperConfig(),
                             JDataConfig(dataset_name="synthetic", max_samples=CLIPS))
    loader = jls.AudioBatchLoader(
        jls.LibriSpeechFeaturesOnly(jls.SyntheticSpeechDataset(CLIPS, seed=3)), batch_size=BATCH)
    jfc.extract_and_cache_features(
        jax.tree_util.tree_map(jnp.asarray, params), JW.WhisperArch(**ARCH), loader, cache,
        encoder_layers=[1], decoder_layers=[0, 1], max_samples=CLIPS, progress=False,
        capture_mlp=True, compute_dtype=jnp.bfloat16 if compute == "bf16" else None,
        mesh=jmesh.make_mesh(2, 1, devices=jax.devices()[:2]))
    return cache


@pytest.mark.parametrize("group,compute", [("f32", "f32"), ("bf16", "bf16"), ("bf16x2", "bf16")])
def test_dp_extraction_matches_single_process_and_jax(port, group, compute):
    root = port["root"] / group
    names = port[group][0]
    assert all(n == names for n in port[group])  # rank 0 wrote, every rank sees it
    mesh_cache = tfc.FeatureCache(root / "mesh", WhisperConfig(),
                                  DataConfig(dataset_name="synthetic", max_samples=CLIPS))
    single = _single_port(root, port["params"], compute)
    jcache = _jax_mesh_cache(root, port["params"], compute)
    assert names == sorted(p.name for p in single.cache_dir.iterdir())
    assert names == sorted(p.name for p in jcache.cache_dir.iterdir())
    for comp, layer in LAYERS:
        got, gm = mesh_cache.load(comp, layer)
        want, wm = single.load(comp, layer)
        assert (gm.num_tokens, gm.num_samples) == (wm.num_tokens, wm.num_samples)
        assert gm.num_samples == CLIPS
        if compute == "bf16":
            assert torch.equal(got, want), (comp, layer)
        else:  # the CPU's f32 products of the one-token decoder sum by row count
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        jmeta = json.loads(jcache._meta_path(comp, layer).read_text())
        tmeta = json.loads(mesh_cache._meta_path(comp, layer).read_text())
        assert {k: v for k, v in tmeta.items() if k != "created_at"} == {
            k: v for k, v in jmeta.items() if k != "created_at"}
        w = np.asarray(jcache.load(comp, layer)[0], np.float32)
        g = got.float().numpy()
        if compute == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{comp}:{layer}")
            continue
        d = np.abs(g - w)
        assert d.max() <= STACK_MAX * np.abs(w).max() and d.mean() <= STACK_MEAN * np.abs(w).mean()


def _run_jax_cli(cfg: Path, monkeypatch):
    log: list = []
    params = _cli_params()

    class Pinned(jtrainer.SAETrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            log.append(self)

        def train_epoch_fused(self, data, shuffle=True, seed=None, defer=None, perm=None):
            perm = np.random.default_rng(self.global_step).permutation(len(data))
            return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, defer=defer,
                                             perm=perm)

    monkeypatch.setattr(jtrainer, "SAETrainer", Pinned)
    monkeypatch.setattr(jsae, "create_sae", lambda c, input_dim, seed=0: jsae.TopKSAE(
        input_dim, c.get_hidden_dim(input_dim), c.k, normalize_decoder=c.normalize_decoder,
        dead_feature_threshold=c.dead_feature_threshold,
        params={k: jnp.asarray(v) for k, v in params.items()}))
    monkeypatch.setattr(jmesh, "mesh_from_config", lambda cfg, devices=None: jmesh.make_mesh(
        2, 1, devices=jax.devices()[:2]))
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", str(cfg), "--no-wandb", "--layer",
                                      "encoder:0"])
    spec = importlib.util.spec_from_file_location("_jax_train_cli_mesh", REPO / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    (trainer,) = log
    return trainer


def test_cli_under_torchrun_env_matches_the_jax_cli(port, monkeypatch):
    root = port["root"] / "cli"
    got = port["cli"]
    assert [g["rank_env"] for g in got] == ["0", "1"]
    assert all(g["mesh"] == {"data": 2, "model": 1} and g["device"] == "cpu" for g in got)
    steps = 2 * -(-N_CLI // B_CLI)
    assert all(g["global_step"] == steps for g in got)
    jt = _run_jax_cli(_cli_config(root, "jax"), monkeypatch)
    assert jt.mesh.shape == {"data": 2, "model": 1} and jt.global_step == steps
    run = "mesh_encoder_layer0"
    tl = [r["loss"] for r in json.loads((root / "port" / run / "metrics.json").read_text())]
    jl = [r["loss"] for r in json.loads((root / "jax" / run / "metrics.json").read_text())]
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    with np.load(root / "port" / run / "sae_final.npz") as z, \
            np.load(root / "jax" / run / "sae_final.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
        for k in z.files:
            np.testing.assert_allclose(z[k], zj[k], atol=2e-4, err_msg=k)
    # rank 0 wrote the JAX CLI's files once (and the port's training_config.json)
    written = {p.name for p in (root / "port" / run).iterdir()}
    assert written == {p.name for p in (root / "jax" / run).iterdir()} | {"training_config.json"}


def test_launcher_jobs_under_torchrun_env_match_one_process(port):
    """``launch extract`` shards its capture over the two ranks (one clip
    each) into the one-process cache, bit for bit; ``launch
    train-transcoder`` takes the two-rank data mesh (the coder kernel's
    plain version on each rank's rows) and holds the one-process run's
    losses at the AMP bar; rank 0 alone writes."""
    from whisper_sae_tpu_torch import launch

    root = port["root"] / "launch"
    single = [launch.main(a) for a in _launch_argvs(root / "single")]
    (ext0, tr0), (ext1, tr1) = port["jobs"]
    assert ext0["encoder_layers"] == [0] and tr0["num_tokens"] == tr1["num_tokens"] == 2 * 1500
    caches = [tfc.FeatureCache(root / d / "cache" / "features", WhisperConfig(), DataConfig())
              for d in ("mesh", "single")]
    for comp in ("encoder", "encoder_mlp_in", "encoder_mlp_out"):
        (got, gm), (want, wm) = (c.load(comp, 0) for c in caches)
        assert gm.num_samples == wm.num_samples == 2 and torch.equal(got, want), comp
    run = "launch_encoder_transcoder_layer0"
    tl, sl = (json.loads((root / d / "out" / run / "metrics.json").read_text())
              for d in ("mesh", "single"))
    assert len(tl) == len(sl) == 6
    np.testing.assert_allclose([r["loss"] for r in tl], [r["loss"] for r in sl], rtol=1e-3)
    assert single[1]["final_loss"] == pytest.approx(tr0["final_loss"], rel=1e-3)
    assert {p.name for p in (root / "mesh" / "out" / run).iterdir()} == {
        p.name for p in (root / "single" / "out" / run).iterdir()}
