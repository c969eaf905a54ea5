"""The port's ``LibriSpeechDataset`` (``data/librispeech.py``) against the
JAX package's, on the CPU: both ingest one local sample stream
(``tests/librispeech_stream.py``: WAV bytes at 16 kHz mono and 22.05 kHz
stereo, one WAV by path, one sample that does not decode) into their own
cache directories, with ``SHARD_MELS`` patched to 4 and
``_load_streaming`` patched to ingest that stream (no test reaches the
network).  Then the cache layouts (shard names, meta json, no temporary
file left), the mels (max abs 1e-4, the bar of
``tests/test_torch_port_mel.py``: the two FFTs sum in other orders), the
loads from a cache (sharded, legacy single-file, one written by the JAX
package: identical arrays and items), the ``_mel128`` stem, the
dataloader factory in both argument orders, a stub processor called as
the JAX package calls it, and the error without ``datasets``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import librispeech_stream as stream
from whisper_sae_tpu.config import DataConfig as JDataConfig
from whisper_sae_tpu.data import librispeech as jls
from whisper_sae_tpu_torch.config import DataConfig
from whisper_sae_tpu_torch.data import librispeech as tls

N, BAD, SHARD = 11, (4,), 4  # 10 good samples: shards of 4 + 4 + 2
MEL_BAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ingest(pkg, cache_dir: Path, samples: list, monkeypatch, n_mels=80, max_samples=N,
            processor=None):
    """``pkg``'s dataset over ``cache_dir``, ingesting ``samples`` when
    there is no cache."""
    cls = pkg.LibriSpeechDataset
    monkeypatch.setattr(cls, "SHARD_MELS", SHARD)
    monkeypatch.setattr(cls, "_load_streaming", lambda self: self._ingest(iter(samples)))
    if pkg is jls:
        return cls(JDataConfig(cache_dir=cache_dir, max_samples=max_samples), processor=processor,
                   n_mels=n_mels)
    return cls(DataConfig(cache_dir=cache_dir, max_samples=max_samples), processor=processor,
               n_mels=n_mels, device="cpu")


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    root = tmp_path_factory.mktemp("librispeech")
    samples = stream.sample_stream(N, seed=25, bad=BAD, path_dir=root)
    mp = pytest.MonkeyPatch()
    try:
        j = _ingest(jls, root / "jax", samples, mp)
        t = _ingest(tls, root / "port", samples, mp)
    finally:
        mp.undo()
    return root, samples, j, t


STEM = f"librispeech_clean_train.100_{N}"


def test_ingest_writes_the_jax_layout(ingested):
    root, _, _, _ = ingested
    names = {d: sorted(p.name for p in (root / d).iterdir()) for d in ("jax", "port")}
    assert names["port"] == names["jax"] == sorted(
        [f"{STEM}_meta.json"] + [f"{STEM}_shard{i:05d}.npy" for i in range(3)])
    assert not list((root / "port").glob("*.tmp*"))
    tmeta, jmeta = (json.loads((root / d / f"{STEM}_meta.json").read_text())
                    for d in ("port", "jax"))
    assert tmeta == jmeta
    assert tmeta["shards"] == [f"{STEM}_shard{i:05d}.npy" for i in range(3)]
    assert [it["id"] for it in tmeta["items"]] == [
        s["id"] for i, s in enumerate(stream.sample_stream(N, seed=25, bad=BAD)) if i not in BAD]
    sizes = [np.load(root / "port" / s, mmap_mode="r").shape for s in tmeta["shards"]]
    assert sizes == [(4, 80, 3000), (4, 80, 3000), (2, 80, 3000)]


def test_ingest_mels_match_jax(ingested):
    root, _, j, t = ingested
    assert len(t) == len(j) == N - len(BAD)
    worst = 0.0
    for name in json.loads((root / "port" / f"{STEM}_meta.json").read_text())["shards"]:
        got, want = np.load(root / "port" / name), np.load(root / "jax" / name)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= MEL_BAR, worst
    for i in (0, 2, 3, 9):  # mono, stereo at 22.05 kHz, by path, the last shard
        assert t[i].keys() == j[i].keys()
        assert {k: v for k, v in t[i].items() if k != "input_features"} == \
            {k: v for k, v in j[i].items() if k != "input_features"}
        np.testing.assert_allclose(t[i]["input_features"], j[i]["input_features"], rtol=0,
                                   atol=MEL_BAR)


def test_cache_loads_without_streaming(ingested, monkeypatch):
    """A fresh instance reads the shards (and the JAX package's cache) with
    ``_load_streaming`` patched to raise: identical arrays and items."""
    root, _, j, t = ingested

    def refuse(self):
        raise AssertionError("streamed although the cache is there")

    monkeypatch.setattr(tls.LibriSpeechDataset, "_load_streaming", refuse)
    for d, ref in (("port", t), ("jax", j)):
        again = tls.LibriSpeechDataset(DataConfig(cache_dir=root / d, max_samples=N))
        assert isinstance(again._features, tls._ShardedMels) and len(again) == len(ref)
        for i in range(len(ref)):
            got, want = again[i], ref[i]
            np.testing.assert_array_equal(got["input_features"], want["input_features"])
            assert {k: v for k, v in got.items() if k != "input_features"} == \
                {k: v for k, v in want.items() if k != "input_features"}


def test_legacy_single_file_layout_loads(ingested, tmp_path, monkeypatch):
    root, _, _, t = ingested
    mels = np.stack([t[i]["input_features"] for i in range(len(t))])
    items = json.loads((root / "port" / f"{STEM}_meta.json").read_text())["items"]
    np.save(tmp_path / f"{STEM}.npy", mels)
    (tmp_path / f"{STEM}_meta.json").write_text(json.dumps(items))
    monkeypatch.setattr(tls.LibriSpeechDataset, "_load_streaming",
                        lambda self: pytest.fail("streamed"))
    got = tls.LibriSpeechDataset(DataConfig(cache_dir=tmp_path, max_samples=N))
    want = jls.LibriSpeechDataset(JDataConfig(cache_dir=tmp_path, max_samples=N))
    assert isinstance(got._features, np.ndarray) and len(got) == len(want) == len(items)
    for i in (0, len(items) - 1):
        np.testing.assert_array_equal(got[i]["input_features"], want[i]["input_features"])
        assert got[i]["id"] == want[i]["id"] == items[i]["id"]
    # a list of items without the single file: the stream is ingested
    (tmp_path / f"{STEM}.npy").unlink()
    with pytest.raises(pytest.fail.Exception, match="streamed"):
        tls.LibriSpeechDataset(DataConfig(cache_dir=tmp_path, max_samples=N))


def test_mel128_stem(tmp_path, monkeypatch):
    samples = stream.sample_stream(3, seed=7)
    j = _ingest(jls, tmp_path / "jax", samples, monkeypatch, n_mels=128, max_samples=3)
    t = _ingest(tls, tmp_path / "port", samples, monkeypatch, n_mels=128, max_samples=3)
    stem = "librispeech_clean_train.100_3_mel128"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        [f"{stem}_meta.json", f"{stem}_shard00000.npy"]
    assert t[0]["input_features"].shape == (128, 3000)
    for i in range(3):
        np.testing.assert_allclose(t[i]["input_features"], j[i]["input_features"], rtol=0,
                                   atol=MEL_BAR)


def test_dataloader_in_both_argument_orders(ingested, monkeypatch):
    root, _, _, _ = ingested
    monkeypatch.setattr(tls.LibriSpeechDataset, "_load_streaming",
                        lambda self: pytest.fail("streamed"))
    jcfg = JDataConfig(cache_dir=root / "jax", max_samples=N)
    cfg = DataConfig(cache_dir=root / "jax", max_samples=N)
    want = list(jls.create_librispeech_dataloader(jcfg, batch_size=4, shuffle=False))
    for loader in (tls.create_librispeech_dataloader(cfg, batch_size=4, shuffle=False),
                   tls.create_librispeech_dataloader(None, cfg, 4, num_workers=2, shuffle=False,
                                                     pin_memory=False),
                   tls.create_librispeech_dataloader(config=cfg, batch_size=4, shuffle=False)):
        assert len(loader) == 3
        got = list(loader)
        assert [b.shape for b in got] == [b.shape for b in want] == [(4, 80, 3000)] * 2 + [
            (2, 80, 3000)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    shuffled = tls.create_librispeech_dataloader(cfg, batch_size=4)
    assert shuffled.shuffle and sum(len(b) for b in shuffled) == N - len(BAD)
    for pkg in (tls, jls):
        with pytest.raises(TypeError, match="DataConfig"):
            pkg.create_librispeech_dataloader(batch_size=4)


class _Processor:
    """A stand-in WhisperProcessor: records each call, returns mels made
    from the waveform."""

    def __init__(self):
        self.calls = []

    def __call__(self, audio, **kw):
        self.calls.append((np.array(audio), kw))
        mel = np.full((1, 80, 3000), float(np.abs(audio).mean()), np.float32)
        mel[0, 0, :len(audio) % 3000] = 1.0
        return type("Out", (), {"input_features": mel})()


def test_processor_is_called_as_jax_calls_it(tmp_path, monkeypatch):
    samples = stream.sample_stream(4, seed=9, bad=(1,))
    jp, tp = _Processor(), _Processor()
    j = _ingest(jls, tmp_path / "jax", samples, monkeypatch, max_samples=4, processor=jp)
    t = _ingest(tls, tmp_path / "port", samples, monkeypatch, max_samples=4, processor=tp)
    assert len(tp.calls) == len(jp.calls) == 3
    for (ta, tkw), (ja, jkw) in zip(tp.calls, jp.calls):
        assert tkw == jkw == {"sampling_rate": 16_000, "return_tensors": "np"}
        assert ta.dtype == ja.dtype == np.float32 and ta.ndim == 1
        np.testing.assert_array_equal(ta, ja)
    for i in range(3):
        np.testing.assert_array_equal(t[i]["input_features"], j[i]["input_features"])


def test_without_datasets_both_raise(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)  # import datasets -> ImportError
    with pytest.raises(RuntimeError, match="HF `datasets` is required") as te:
        tls.LibriSpeechDataset(DataConfig(cache_dir=tmp_path / "port", max_samples=2))
    with pytest.raises(RuntimeError) as je:
        jls.LibriSpeechDataset(JDataConfig(cache_dir=tmp_path / "jax", max_samples=2))
    assert str(te.value) == str(je.value)
    assert isinstance(te.value.__cause__, ImportError)


def test_ingest_needs_the_card_unless_asked(tmp_path, monkeypatch):
    """Without a card and without ``device`` the ingest raises before it
    writes anything (the per-sample skip does not swallow it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    samples = stream.sample_stream(2, seed=3)
    monkeypatch.setattr(tls.LibriSpeechDataset, "_load_streaming",
                        lambda self: self._ingest(iter(samples)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tls.LibriSpeechDataset(DataConfig(cache_dir=tmp_path, max_samples=2))
    assert list(tmp_path.iterdir()) == []
    audio, rate = tls.LibriSpeechDataset._decode(samples[0]["audio"])
    assert rate == stream.MONO_RATE and audio.shape == (16_000,)
