"""The port's extraction loop (``data/feature_cache.py:extract_and_cache_features``)
and dataset (``data/librispeech.py``) against the JAX package's, on the CPU.

Both packages extract the same ``SyntheticSpeechDataset`` clips (each
through its own log-mel) with the same parameters into caches of the
same files and metadata.  Bars per layer cache: f32 compute at rtol
1e-4, atol 1e-4 (the two log-mels differ by up to 1.5e-5); bf16 compute
(JAX composed on the CPU, the port's fused plain versions) at the stack
bar, max|d| <= 2**-4 * max|ref|, mean|d| <= 2**-7 * mean|ref|.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu.config import DataConfig as JDataConfig
from whisper_sae_tpu.config import WhisperConfig as JWhisperConfig
from whisper_sae_tpu.data import feature_cache as jfc
from whisper_sae_tpu.data import librispeech as jls
from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig
from whisper_sae_tpu_torch.data import feature_cache as tfc
from whisper_sae_tpu_torch.data import librispeech as tls
from whisper_sae_tpu_torch.models import whisper as TW

ARCH = dict(d_model=64, encoder_layers=2, decoder_layers=2, num_heads=1, ffn_dim=128,
            max_source_positions=1500, max_target_positions=8, vocab_size=64,
            decoder_start_token_id=1, eos_token_id=2)
N_CLIPS, BATCH = 4, 2
STACK_MAX, STACK_MEAN = 2.0**-4, 2.0**-7

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs one worker process per core: keep torch's intra-op
    pool to one thread here, or the workers' pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def setup():
    params = JW.init_whisper(jax.random.PRNGKey(0), JW.WhisperArch(**ARCH))
    key = jax.random.PRNGKey(1)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * jax.random.normal(key, a.shape), params)
    return params, TW.params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _loaders(n=N_CLIPS, batch=BATCH):
    j = jls.AudioBatchLoader(jls.LibriSpeechFeaturesOnly(jls.SyntheticSpeechDataset(n, seed=3)),
                             batch_size=batch)
    t = tls.AudioBatchLoader(tls.LibriSpeechFeaturesOnly(tls.SyntheticSpeechDataset(n, seed=3)),
                             batch_size=batch)
    return j, t


def _caches(tmp_path):
    data = dict(dataset_name="synthetic", max_samples=N_CLIPS)
    j = jfc.FeatureCache(tmp_path / "jax", JWhisperConfig(), JDataConfig(**data))
    t = tfc.FeatureCache(tmp_path / "port", WhisperConfig(), DataConfig(**data))
    return j, t


def test_synthetic_dataset_matches_jax():
    j = jls.SyntheticSpeechDataset(70, seed=5)
    t = tls.SyntheticSpeechDataset(70, seed=5)
    assert len(t) == 70
    for i in (0, 69):  # both mel chunks
        np.testing.assert_array_equal(t.waveform(i), j.waveform(i))
        jt, tt = j[i], t[i]
        assert set(tt) == set(jt) and tt["id"] == jt["id"] and tt["speaker_id"] == jt["speaker_id"]
        assert tt["input_features"].shape == (80, 3000)
        np.testing.assert_allclose(tt["input_features"], jt["input_features"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["f32", "bf16-f32-cache", "bf16-bf16-cache"])
def test_extract_and_cache_matches_jax(tmp_path, setup, mode):
    jparams, tparams = setup
    jcache, tcache = _caches(tmp_path)
    jload, tload = _loaders()
    bf16 = mode != "f32"
    cache_dtype = "bfloat16" if mode == "bf16-bf16-cache" else None
    kw = dict(encoder_layers=[1], decoder_layers=[0, 1], max_samples=N_CLIPS, progress=False,
              cache_dtype=cache_dtype)
    jfc.extract_and_cache_features(jparams, JW.WhisperArch(**ARCH), jload, jcache,
                                   compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    tfc.extract_and_cache_features(tparams, TW.WhisperArch(**ARCH), tload, tcache,
                                   compute_dtype=torch.bfloat16 if bf16 else None, **kw)
    assert sorted(p.name for p in tcache.cache_dir.iterdir()) == sorted(
        p.name for p in jcache.cache_dir.iterdir())
    for comp, layer in (("encoder", 1), ("decoder", 0), ("decoder", 1)):
        jmeta = json.loads(jcache._meta_path(comp, layer).read_text())
        tmeta = json.loads(tcache._meta_path(comp, layer).read_text())
        assert set(tmeta) == set(jmeta)
        for k in jmeta:
            if k != "created_at":
                assert tmeta[k] == jmeta[k], k
        want, _ = jcache.load(comp, layer)
        got, _ = tcache.load(comp, layer)
        assert got.dtype == (torch.bfloat16 if cache_dtype else torch.float32)
        w = np.asarray(want, np.float32)
        g = got.float().numpy()
        assert g.shape == w.shape == (N_CLIPS * (1500 if comp == "encoder" else 1), 64)
        if not bf16:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{comp}:{layer}")
            continue
        d = np.abs(g - w)
        mx, mn = float(d.max() / np.abs(w).max()), float(d.mean() / np.abs(w).mean())
        print(f"{mode} {comp}:{layer}: max rel {mx:.3g}, mean rel {mn:.3g}")
        assert mx <= STACK_MAX and mn <= STACK_MEAN, (comp, layer, mx, mn)


class _CrashingLoader:
    def __init__(self, loader, crash_at):
        self.loader, self.crash_at = loader, crash_at

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if i == self.crash_at:
                raise RuntimeError("simulated preemption")
            yield b


def test_resume_matches_uninterrupted(tmp_path, setup):
    _, tparams = setup
    arch = TW.WhisperArch(**ARCH)
    kw = dict(encoder_layers=[0], decoder_layers=[1], progress=False,
              compute_dtype=torch.bfloat16, capture_mlp=True)
    _, want_cache = _caches(tmp_path / "want")
    tfc.extract_and_cache_features(tparams, arch, _loaders(6, 1)[1], want_cache, **kw)
    _, got_cache = _caches(tmp_path / "got")
    with pytest.raises(RuntimeError, match="preemption"):
        tfc.extract_and_cache_features(tparams, arch, _CrashingLoader(_loaders(6, 1)[1], 4),
                                       got_cache, checkpoint_every=2, **kw)
    progress = got_cache.cache_dir / "extraction_progress.json"
    snap = json.loads(progress.read_text())
    assert snap["num_samples"] == 2 and snap["cache_dtype"] == "float32"  # drain lags by a batch
    assert set(snap["writers"]) == {"encoder:0", "decoder:1", "encoder_mlp_in:0",
                                    "encoder_mlp_out:0", "decoder_mlp_in:1", "decoder_mlp_out:1"}
    tfc.extract_and_cache_features(tparams, arch, _loaders(6, 1)[1], got_cache, resume=True,
                                   checkpoint_every=2, **kw)
    assert not progress.exists()
    for comp, layer in (("encoder", 0), ("decoder", 1), ("encoder_mlp_out", 0),
                        ("decoder_mlp_in", 1)):
        got, gm = got_cache.load(comp, layer)
        want, wm = want_cache.load(comp, layer)
        assert gm.num_samples == wm.num_samples == 6
        assert torch.equal(got, want), (comp, layer)


def test_extraction_refuses_a_mesh_and_bf16_cache_without_bf16(tmp_path, setup):
    _, tparams = setup
    _, cache = _caches(tmp_path)
    arch = TW.WhisperArch(**ARCH)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tfc.extract_and_cache_features(tparams, arch, [], cache, [0], [], mesh=object())
    with pytest.raises(ValueError, match="requires bf16"):
        tfc.extract_and_cache_features(tparams, arch, [], cache, [0], [], cache_dtype="bfloat16")


def test_cli_extracts_then_trains_from_the_cache(tmp_path):
    """``--extract-only --random-whisper --device cpu`` writes whisper-tiny
    caches for the configured layers; the same CLI then trains one epoch
    from one of them."""
    import yaml

    from whisper_sae_tpu_torch import train as cli

    cfg = yaml.safe_load((Path(__file__).resolve().parent.parent / "configs" /
                          "tiny_default.yaml").read_text())
    cfg["data"].update(dataset_name="synthetic", max_samples=2, cache_dir=str(tmp_path / "cache"))
    cfg["training"].update(epochs=1, batch_size=512, warmup_steps=2)
    cfg.update(encoder_layers=[0, 3], decoder_layers=[2], output_dir=str(tmp_path / "out"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    base = ["--config", str(path), "--device", "cpu", "--no-wandb"]
    assert cli.main(base + ["--extract-only", "--random-whisper"]) == {}
    cache = tfc.FeatureCache(tmp_path / "cache" / "features", WhisperConfig(), DataConfig())
    for comp, layer, tokens in (("encoder", 0, 3000), ("encoder", 3, 3000), ("decoder", 2, 2)):
        meta = cache.load_metadata(comp, layer)
        assert (meta.num_tokens, meta.hidden_dim, meta.num_samples) == (tokens, 384, 2)
        rows, _ = cache.load(comp, layer)
        assert bool(torch.isfinite(rows).all())
    (trainer,) = cli.main(base + ["--layer", "encoder:3"]).values()
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    assert len(rows) == 6 and np.isfinite([r["loss"] for r in rows]).all()
