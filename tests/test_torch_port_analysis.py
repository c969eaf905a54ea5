"""The port's analysis layer (``whisper_sae_tpu_torch.analysis``) against the
JAX package's on the CPU, from the same numpy-seeded activations.

The tracker's running ``[F, k]`` state (values, samples, positions) is
held bit for bit against JAX's, with exact ties among the values, features
that never fire and batches of fewer rows than k (the -inf padding is one
large tie: ``jax.lax.top_k`` keeps the lower index first, and so must the
port).  The files the layer writes -- ``tracker_state.json``,
``summary.json``, ``features/*.json``, the coactivation counts and pairs,
the clips' WAV bytes and manifest, the dashboard's HTML and the lexical
auto-labels -- are byte-identical.  ``collect_top_activations`` through
an SAE's encode agrees on the samples and positions, the values at f32
rtol 1e-5 (the encode products sum in another order).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu import analysis as jan
from whisper_sae_tpu.data.librispeech import SyntheticSpeechDataset as JSynthetic
from whisper_sae_tpu.models.sae import TopKSAE as JTopKSAE
from whisper_sae_tpu_torch import analysis as tan
from whisper_sae_tpu_torch.data.librispeech import SyntheticSpeechDataset
from whisper_sae_tpu_torch.models.sae import TopKSAE
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

F, K = 48, 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed: int, shape=(3, 7), n: int = 4, coarse: bool = True) -> list[np.ndarray]:
    """ReLU'd activations ``[*shape, F]``: on a coarse grid (many exact
    ties), the first 5 features never firing, a few rows all zero."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h = np.maximum(rng.standard_normal((*shape, F)), 0)
        if coarse:
            h = np.round(h * 2) / 2
        h[..., :5] = 0
        h.reshape(-1, F)[::5] = 0
        out.append(h.astype(np.float32))
    return out


def _trackers(batches, k: int = K, texts: bool = True):
    jt, tt = jan.TopKTracker(F, k), tan.TopKTracker(F, k, device="cpu")
    lo = 0
    for h in batches:
        b = h.shape[0]
        ids = np.arange(lo, lo + b)
        tr = [f"utterance {i} word{i % 3}" for i in ids] if texts else None
        jt.update(jnp.asarray(h), ids, transcriptions=tr)
        tt.update(torch.from_numpy(h), ids, transcriptions=tr)
        lo += b
    return jt, tt


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_state(jt, tt) -> None:
    for name in ("_values", "_samples", "_positions"):
        np.testing.assert_array_equal(_bits(getattr(jt, name)), _bits(getattr(tt, name).numpy()),
                                      err_msg=name)
    assert (jt.total_activations, jt.samples_processed) == (tt.total_activations,
                                                            tt.samples_processed)


@pytest.mark.parametrize("case", ["ties_3d", "smooth_3d", "ties_2d", "fewer_rows_than_k"])
def test_tracker_state_bit_equal_to_jax(case):
    if case == "ties_3d":
        batches = _batches(0)
    elif case == "smooth_3d":
        batches = _batches(1, coarse=False)
    elif case == "ties_2d":
        batches = _batches(2, shape=(9,))
    else:  # two rows a batch: the candidates' -inf padding decides the kept slots
        batches = _batches(3, shape=(2,), n=3)
    jt, tt = _trackers(batches)
    _same_state(jt, tt)
    assert np.isinf(np.asarray(jt._values[:5])).all()  # the features that never fire
    for fi in (0, 7, F - 1):
        assert [e.to_dict() for e in jt.get_top_examples(fi)] == [
            e.to_dict() for e in tt.get_top_examples(fi)]
    assert jt.get_feature_stats() == tt.get_feature_stats()


def test_tracker_save_load_same_json(tmp_path):
    jt, tt = _trackers(_batches(4))
    jt.save(tmp_path / "j.json")
    tt.save(tmp_path / "t.json")
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    # each package loads the other's file to the same state and writes it back unchanged
    jl = jan.TopKTracker.load(tmp_path / "t.json")
    tl = tan.TopKTracker.load(tmp_path / "j.json", device="cpu")
    _same_state(jl, tl)
    tl.save(tmp_path / "t2.json")
    assert (tmp_path / "t2.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    # and merging on after a load stays equal
    more = _batches(5, n=1)[0]
    jl.update(jnp.asarray(more), np.arange(100, 103))
    tl.update(torch.from_numpy(more), np.arange(100, 103))
    _same_state(jl, tl)


def _report_tree(pkg, tracker, root: Path, label: bool) -> None:
    report = pkg.FeatureReport(tracker, root)
    if label:
        tops = report.generate_summary_report(top_n=10)["top_features"]
        labels = pkg.auto_label_features(tracker, report,
                                         feature_indices=[f["feature_idx"] for f in tops],
                                         min_examples=2)
        (root / "labels.json").write_text(json.dumps({str(k): v for k, v in labels.items()}))
    report.add_interpretation(7, "manual", "a test label", confidence=0.8, evidence=["x"])
    report.save_reports(top_n=10)


def _tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("label", [False, True], ids=["plain", "auto_label"])
def test_reports_identical(tmp_path, label):
    jt, tt = _trackers(_batches(6))
    _report_tree(jan, jt, tmp_path / "jax", label)
    _report_tree(tan, tt, tmp_path / "port", label)
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) >= 12
    for name in want:
        assert got[name] == want[name], name
    if label:
        assert json.loads(want["labels.json"])  # some features were labelled


@pytest.mark.parametrize("feats", [list(range(F)), [9, 3, 30, 3, 17]], ids=["all", "subset"])
def test_coactivation_equal(tmp_path, feats):
    chunks = [h.reshape(-1, F) for h in _batches(7, n=5)]

    def enc(pkg_tensor):
        return lambda lo, hi: pkg_tensor(np.concatenate(chunks[lo:hi]))

    jco = jan.compute_coactivation(enc(jnp.asarray), 5, 2, feats, top_pairs=20)
    tco = tan.compute_coactivation(enc(torch.from_numpy), 5, 2, feats, top_pairs=20)
    assert tco == jco and jco["top_pairs"]
    jan.save_coactivation(jco, tmp_path / "j.json")
    tan.save_coactivation(tco, tmp_path / "t.json")
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()


def _clips_and_dashboard(pkg, tracker, ds, root: Path) -> None:
    report = pkg.FeatureReport(tracker, root)
    report.save_reports(top_n=8)
    ex = pkg.AudioClipExtractor(tracker, pkg.create_synthetic_audio_loader(ds), root / "audio")
    feats = [f["feature_idx"] for f in report.generate_summary_report(top_n=4)["top_features"]]
    written = ex.extract_all_clips(feature_indices=feats, max_clips_per_feature=3)
    assert sum(len(v) for v in written.values()) > 0
    ex.save_manifest()
    chunks = [np.asarray(tracker._values[:, :1]).T for _ in range(2)]  # any [rows, F] hidden
    pkg.save_coactivation(pkg.compute_coactivation(lambda lo, hi: np.maximum(
        np.concatenate(chunks[lo:hi]), 0), 2, 1, feats), root / "coactivation.json")
    pkg.generate_dashboard(root)


def test_clips_manifest_and_dashboard_identical(tmp_path):
    """Clips cut from the synthetic dataset's waveforms (2 s; positions in
    frames of 10 ms, as the reference's convention), their WAV bytes, the
    manifest (its paths relative to each tree) and the dashboard HTML that
    links them."""
    rng = np.random.default_rng(8)
    h = np.maximum(rng.standard_normal((4, 150, F)), 0).astype(np.float32)
    h[:, 120:] = 0  # keep the top positions inside the 2 s clips
    jt, tt = jan.TopKTracker(F, 4), tan.TopKTracker(F, 4, device="cpu")
    jt.update(jnp.asarray(h), np.arange(4))
    tt.update(torch.from_numpy(h), np.arange(4))
    _clips_and_dashboard(jan, jt, JSynthetic(num_samples=4, seed=3), tmp_path / "jax")
    _clips_and_dashboard(tan, tt, SyntheticSpeechDataset(num_samples=4, seed=3), tmp_path / "port")
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert any(n.endswith(".wav") for n in want) and "dashboard.html" in want
    for name in want:
        if name.endswith("manifest.json"):
            assert got[name].decode().replace(str(tmp_path / "port"), "ROOT") == \
                want[name].decode().replace(str(tmp_path / "jax"), "ROOT"), name
        else:
            assert got[name] == want[name], name
    assert b"<audio" in got["dashboard.html"]


def test_collect_top_activations_through_an_sae():
    """``collect_top_activations`` through a TopK SAE's f32 encode (the
    port's: the f32 product and the plain top-k on the CPU) against JAX's
    with the same parameters: the same samples and positions, the values
    at rtol 1e-5."""
    d, h, k = 32, 64, 4
    jsae = JTopKSAE(d, h, k, seed=0)
    tsae = TopKSAE(d, h, k, params=params_from_jax({n: np.asarray(v) for n, v in
                                                    jsae.params.items()}), device="cpu")
    rng = np.random.default_rng(9)
    batches = [rng.standard_normal((6, 10, d)).astype(np.float32) for _ in range(3)]

    class _Flat:  # encode [B, S, D] -> [B, S, H], as a per-sample model would
        def __init__(self, sae, to):
            self.sae, self.to = sae, to

        def encode(self, x):
            x = self.to(x)
            return self.sae.encode(x.reshape(-1, d)).reshape(x.shape[0], x.shape[1], h)

    jt = jan.collect_top_activations(_Flat(jsae, jnp.asarray), batches, h, k=5)
    tt = tan.collect_top_activations(_Flat(tsae, torch.as_tensor), batches, h, k=5, device="cpu")
    np.testing.assert_array_equal(np.asarray(jt._samples), tt._samples.numpy())
    np.testing.assert_array_equal(np.asarray(jt._positions), tt._positions.numpy())
    np.testing.assert_allclose(tt._values.numpy(), np.asarray(jt._values), rtol=1e-5)
    assert jt.total_activations == tt.total_activations
