"""The port's feature cache and loader against the JAX package's.

A cache written by the JAX package, f32 or bf16, single- or multi-shard,
loads in the port with identical rows; a cache written by the port loads
in the JAX package; ``ActivationLoader`` gives the same batch order for
the same seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_sae_tpu.config import DataConfig as JDataConfig
from whisper_sae_tpu.config import WhisperConfig as JWhisperConfig
from whisper_sae_tpu.data.feature_cache import FeatureCache as JFeatureCache
from whisper_sae_tpu.data.loader import ActivationLoader as JActivationLoader
from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig
from whisper_sae_tpu_torch.data.feature_cache import FeatureCache
from whisper_sae_tpu_torch.data.loader import ActivationLoader

D = 384


def _features(n=300, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _caches(tmp_path):
    j = JFeatureCache(tmp_path, JWhisperConfig(), JDataConfig())
    t = FeatureCache(tmp_path, WhisperConfig(), DataConfig())
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shard_tokens", [1 << 21, 128])
def test_jax_written_cache_loads(tmp_path, dtype, shard_tokens):
    jc, tc = _caches(tmp_path)
    feats = _features()
    w = jc.writer("encoder", 1, shard_tokens=shard_tokens, dtype=dtype)
    w.append(feats[:200])
    w.append(feats[200:])
    w.finalize(num_samples=3)
    assert tc.has_cache("encoder", 1) and not tc.has_cache("encoder", 2)
    meta = tc.load_metadata("encoder", 1)
    assert (meta.num_tokens, meta.hidden_dim, meta.dtype) == (300, D, dtype)
    rows, _ = tc.load("encoder", 1)
    want, _ = jc.load("encoder", 1)
    assert rows.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(rows.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_written_cache_loads_in_jax(tmp_path, dtype):
    jc, tc = _caches(tmp_path)
    feats = _features(seed=1)
    w = tc.writer("decoder", 0, shard_tokens=100, dtype=dtype)
    for i in range(3):
        w.append(feats[i * 100:(i + 1) * 100])
    w.finalize(num_samples=2)
    got, meta = jc.load("decoder", 0)
    assert meta.dtype == dtype and len(meta.shards) == 3
    want = torch.from_numpy(feats).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(np.asarray(got, np.float32), want.float().numpy())


def test_mixed_dtype_cache_rejected(tmp_path):
    jc, tc = _caches(tmp_path)
    jc.save(_features(), "encoder", 0, num_samples=1)
    meta_path = tmp_path / "whisper-tiny_encoder_layer0_meta.json"
    meta_path.write_text(meta_path.read_text().replace('"float32"', '"bfloat16"'))
    with pytest.raises(ValueError, match="corrupt"):
        tc.load("encoder", 0)


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_matches_jax(drop_last):
    feats = _features(n=203, seed=2)
    jl = JActivationLoader(feats, 32, seed=5, drop_last=drop_last)
    tl = ActivationLoader(torch.from_numpy(feats), 32, seed=5, drop_last=drop_last)
    assert len(tl) == len(jl)
    for _ in range(2):  # a new order each epoch, from the same stream
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.numpy(), a)


def test_dataloader_from_cache(tmp_path):
    jc, tc = _caches(tmp_path)
    feats = _features(n=130, seed=3)
    jc.save(feats, "encoder", 3, num_samples=1)
    tl = tc.get_dataloader("encoder", 3, batch_size=64, seed=1)
    jl = jc.get_dataloader("encoder", 3, batch_size=64, seed=1)
    assert len(tl) == 3 and tl.num_tokens == 130
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), a)
