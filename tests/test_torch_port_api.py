"""The single-device API entries the port adds to match the JAX package,
against the JAX functions on the CPU from the same numpy inputs:
``LayerConfig``, ``FeatureCache.save``, the sparse top-k form
(``ops/topk.py``: ``topk_select``, ``scatter_topk``, ``sparse_decode``,
``topk_encode``), ``topk_encode_sparse`` and ``TopKSAE.encode_sparse``,
``init_dead_state``, ``from_hf_torch``, ``import_torch_state_dict`` and
the package exports.

Tolerances: the top-k indices bit for bit, ties included (``jax.lax.top_k``
ranks equal values by the lower index first); on rows whose products are
exact in f32 (small integers over powers of two, where every order of the
sums gives the same bits) the values exactly too; on gaussian rows the f32
values at rtol 1e-6 (two BLAS sum orders) and the bf16-operand products at
rtol 2**-8; the sparse decode at rtol 1e-5; shards, metadata, parameters
and state dicts byte for byte.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu import config as jconfig
from whisper_sae_tpu.data import feature_cache as jfc
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.ops import topk as jtopk
from whisper_sae_tpu.utils import checkpoint as jckpt
from whisper_sae_tpu_torch import config as tconfig
from whisper_sae_tpu_torch.data import feature_cache as tfc
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models import whisper as TW
from whisper_sae_tpu_torch.ops import topk as ttopk
from whisper_sae_tpu_torch.utils import checkpoint as tckpt
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

REPO = Path(__file__).resolve().parent.parent
D, H, K, B = 64, 256, 8, 96


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# config and cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(component="encoder", layer_idx=3, input_dim=384),
    dict(component="decoder", layer_idx=0, input_dim=512,
         sae_config={"expansion_factor": 4, "k": 16}, training_config={"batch_size": 64}),
])
def test_layer_config_matches_jax(kw):
    j, t = jconfig.LayerConfig(**kw), tconfig.LayerConfig(**kw)
    assert t.name == j.name and t.hidden_dim == j.hidden_dim
    assert t.model_dump(mode="json") == j.model_dump(mode="json")
    for bad in (dict(kw, layer_idx=-1), dict(kw, component="middle")):
        with pytest.raises(ValueError):
            tconfig.LayerConfig(**bad)
        with pytest.raises(ValueError):
            jconfig.LayerConfig(**bad)


class _FixedClock:
    @staticmethod
    def now():
        class _T:
            @staticmethod
            def isoformat():
                return "2026-01-01T00:00:00"
        return _T()


@pytest.mark.parametrize("shard_tokens,as_tensor", [(None, False), (100, True)],
                         ids=["default_shard", "small_shard_tensor_rows"])
def test_feature_cache_save_matches_jax(tmp_path, monkeypatch, shard_tokens, as_tensor):
    """Shards and metadata byte for byte (the creation time pinned in
    both), read back bit for bit."""
    monkeypatch.setattr(jfc, "datetime", _FixedClock)
    monkeypatch.setattr(tfc, "datetime", _FixedClock)
    rows = np.random.default_rng(0).standard_normal((300, D)).astype(np.float32)
    kw = {} if shard_tokens is None else {"shard_tokens": shard_tokens}
    jcache = jfc.FeatureCache(tmp_path / "jax", jconfig.WhisperConfig(), jconfig.DataConfig())
    tcache = tfc.FeatureCache(tmp_path / "port", tconfig.WhisperConfig(), tconfig.DataConfig())
    jmeta = jcache.save(rows, "encoder", 2, num_samples=3, **kw)
    tmeta = tcache.save(torch.from_numpy(rows) if as_tensor else rows, "encoder", 2,
                        num_samples=3, **kw)
    assert tmeta.shards == jmeta.shards and len(tmeta.shards) == 1
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    back, meta = tcache.load("encoder", 2)
    assert meta.num_tokens == 300 and meta.dtype == "float32"
    np.testing.assert_array_equal(back.numpy(), rows)


# ---------------------------------------------------------------------------
# the sparse top-k form
# ---------------------------------------------------------------------------


def _tie_rows() -> np.ndarray:
    """[B, H] pre rows full of exact ties: a few values repeated across the
    row, all-equal rows, negative rows (selected values relu'd to 0), and
    +0.0 / -0.0 mixed."""
    rng = np.random.default_rng(3)
    pre = rng.integers(-3, 4, (B, H)).astype(np.float32) / 4
    pre[0] = 1.0
    pre[1] = -1.0
    pre[2] = 0.0
    pre[2, ::3] = -0.0
    pre[3, : H // 2] = -0.0
    pre[4] = np.where(np.arange(H) % 2 == 0, 0.5, -0.0)
    return pre


def _grid(shape, seed: int, lo: int = -4, hi: int = 5, scale: float = 8.0) -> np.ndarray:
    """Small integers over a power of two: products and their sums exact in f32."""
    return (np.random.default_rng(seed).integers(lo, hi, shape) / scale).astype(np.float32)


def _sae_params(kind: str) -> dict[str, np.ndarray]:
    if kind == "grid":
        return {"w_enc": _grid((D, H), 1), "b_enc": _grid(H, 2), "b_pre": _grid(D, 3),
                "w_dec": _grid((H, D), 4), "b_dec": _grid(D, 5)}
    rng = np.random.default_rng(6)
    return {"w_enc": rng.standard_normal((D, H)).astype(np.float32) / 8,
            "b_enc": rng.standard_normal(H).astype(np.float32) / 8,
            "b_pre": rng.standard_normal(D).astype(np.float32) / 8,
            "w_dec": rng.standard_normal((H, D)).astype(np.float32) / 8,
            "b_dec": rng.standard_normal(D).astype(np.float32) / 8}


def _rows(kind: str) -> np.ndarray:
    if kind == "grid":
        return _grid((B, D), 7)
    return np.random.default_rng(8).standard_normal((B, D)).astype(np.float32)


@pytest.mark.parametrize("k", [1, K, H])
def test_topk_select_ranks_ties_as_jax(k):
    pre = _tie_rows()
    jv, ji = jtopk.topk_select(jnp.asarray(pre), k)
    tv, ti = ttopk.topk_select(torch.from_numpy(pre), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    dense_j = jtopk.scatter_topk(jv, ji, H)
    dense_t = ttopk.scatter_topk(tv, ti, H)
    np.testing.assert_array_equal(dense_t.numpy().view(np.int32),
                                  np.asarray(dense_j).view(np.int32))


def test_top_k_is_the_trackers():
    """The tracker's merge ranks with ``ops.topk.top_k`` (one copy)."""
    from whisper_sae_tpu_torch.analysis import feature_viz

    assert feature_viz.top_k is ttopk.top_k
    vals = torch.from_numpy(_tie_rows())
    want = jax.lax.top_k(jnp.asarray(vals.numpy()), 17)
    got = ttopk.top_k(vals, 17)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("kind", ["grid", "gaussian"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_topk_encode_and_sparse_decode_match_jax(kind, compute):
    p, x = _sae_params(kind), _rows(kind)
    jdt, tdt = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16, torch.bfloat16)
    jv, ji = jtopk.topk_encode(jnp.asarray(x), *(jnp.asarray(p[n]) for n in
                                                 ("w_enc", "b_enc", "b_pre")), K, jdt)
    tp = params_from_jax(p)
    tv, ti = ttopk.topk_encode(torch.from_numpy(x), tp["w_enc"], tp["b_enc"], tp["b_pre"], K, tdt)
    assert tv.dtype == torch.float32 and tuple(ti.shape) == (B, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if kind == "grid":  # exact products: every bit, ties among them
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert any(len(set(r)) < K for r in np.asarray(jv).tolist())
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6 if compute == "f32"
                                   else 2 ** -8, atol=1e-6)
    want = jtopk.sparse_decode(jv, ji, jnp.asarray(p["w_dec"]), jnp.asarray(p["b_dec"]))
    got = ttopk.sparse_decode(tv, ti, tp["w_dec"], tp["b_dec"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    dense = ttopk.scatter_topk(tv, ti, H)
    np.testing.assert_allclose(got.numpy(), (dense @ tp["w_dec"] + tp["b_dec"]).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sparse_decode_casts_to_the_decoder_dtype():
    p, x = _sae_params("gaussian"), _rows("gaussian")
    jv, ji = jtopk.topk_encode(jnp.asarray(x), *(jnp.asarray(p[n]) for n in
                                                 ("w_enc", "b_enc", "b_pre")), K)
    want = jtopk.sparse_decode(jv, ji, jnp.asarray(p["w_dec"]).astype(jnp.bfloat16),
                               jnp.asarray(p["b_dec"]))
    got = ttopk.sparse_decode(torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(ji)),
                              torch.from_numpy(p["w_dec"]).bfloat16(), torch.from_numpy(p["b_dec"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["grid", "gaussian"])
def test_sparse_encode_and_facade_match_jax(kind):
    p, x = _sae_params(kind), _rows(kind)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    jv, ji = jsae.topk_encode_sparse(jp, jnp.asarray(x), K)
    tv, ti = tsae.topk_encode_sparse(params_from_jax(p), torch.from_numpy(x), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    fv, fi = jsae.TopKSAE(D, H, K, params=jp).encode_sparse(x)
    model = tsae.TopKSAE(D, H, K, params=params_from_jax(p), device="cpu")
    mv, mi = model.encode_sparse(x)
    assert mv.device == model.device
    np.testing.assert_array_equal(mi.numpy(), np.asarray(fi))
    for got, want in ((tv, jv), (mv.detach(), fv)):
        if kind == "grid":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the dense latent the facade's encode gives, where no tie sits at the threshold
    dense = ttopk.scatter_topk(mv.detach(), mi, H)
    enc = model.encode(x).detach()
    pre = torch.from_numpy(x - p["b_pre"]) @ torch.from_numpy(p["w_enc"]) + torch.from_numpy(p["b_enc"])
    kth = torch.topk(pre, K + 1).values
    clean = kth[:, K - 1] > kth[:, K]
    assert clean.sum() > B // 2
    torch.testing.assert_close(dense[clean], enc[clean], rtol=1e-6, atol=1e-6)


def test_init_dead_state_matches_jax():
    j = jsae.init_dead_state(H)
    t = tsae.init_dead_state(H, device="cpu")
    assert isinstance(t, tsae.DeadFeatureState) and t._fields == j._fields
    for a, b in zip(t, j):
        assert tuple(a.shape) == b.shape and a.dtype == torch.int32 and b.dtype == jnp.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    model = tsae.TopKSAE(D, H, K, device="cpu")
    model.state = t
    assert torch.equal(model.get_dead_features(), torch.zeros(H, dtype=torch.bool))


# ---------------------------------------------------------------------------
# weights across formats
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf():
    """A random HF Whisper at a small geometry, built offline."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=80, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2, d_model=32,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=16, max_target_positions=8,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=0, bos_token_id=1)
    torch.manual_seed(0)
    return transformers.WhisperForConditionalGeneration(cfg).eval()


@pytest.mark.parametrize("which", ["conditional_generation", "model"])
def test_from_hf_torch_matches_jax(hf, which):
    """With (``WhisperForConditionalGeneration``) and without
    (``WhisperModel``) the ``model.`` prefix: every leaf and arch field."""
    model = hf if which == "conditional_generation" else hf.model
    want, jarch = JW.from_hf_torch(model)
    got, arch = TW.from_hf_torch(model)
    assert vars(arch) == vars(jarch)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert node.device.type == "cpu" and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("arrays", [False, True], ids=["tensors", "numpy"])
def test_import_torch_state_dict_matches_jax(arrays):
    p = _sae_params("gaussian")
    sd = jckpt.export_torch_state_dict({n: jnp.asarray(v) for n, v in p.items()},
                                       state=jsae.init_dead_state(H))
    if arrays:
        sd = {k: v.numpy() for k, v in sd.items()}
    want = jckpt.import_torch_state_dict(sd)
    got = tckpt.import_torch_state_dict(sd)
    assert sorted(got) == sorted(want) == sorted(p)
    for n in p:
        assert got[n].is_contiguous()
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        np.testing.assert_array_equal(got[n].numpy(), p[n])
    # round trip through the port's export, dead-feature state included
    tp = params_from_jax(p)
    state = tsae.init_dead_state(H, device="cpu")
    out = tckpt.export_torch_state_dict(tp, state=state)
    back = tckpt.import_torch_state_dict(out)
    assert all(torch.equal(back[n], tp[n]) for n in tp)
    partial = tckpt.import_torch_state_dict({"b_pre": out["b_pre"]})
    assert list(partial) == ["b_pre"]


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

_EXPORTS = """
import importlib, json, sys
names = json.loads(sys.argv[1])
missing = []
for mod, want in names.items():
    m = importlib.import_module(mod)
    missing += [f"{mod}.{n}" for n in want if not hasattr(m, n) or n not in m.__all__]
bad = sorted(x for x in sys.modules if x.split(".")[0] in ("jax", "jaxlib", "whisper_sae_tpu"))
maps = open("/proc/self/maps").read()
loaded = sorted({l.split()[-1] for l in maps.splitlines()
                 if any(s in l for s in ("libwst", "libcuda", "libcudart", "libnvrtc"))})
import torch
from whisper_sae_tpu_torch.ops import _build
from whisper_sae_tpu_torch.runtime import shard_reader
print(json.dumps({"missing": missing, "bad": bad, "loaded": loaded,
                  "cuda_init": torch.cuda.is_initialized(), "kernels": _build._lib is not None,
                  "wstio": shard_reader._lib is not None}))
"""


def test_exports_match_jax_and_load_nothing():
    """Every name of the JAX package's ``__all__`` lists and the runtime's
    names import from the port, in a process of its own that then holds
    no jax module and no CUDA or kernel library, with nothing built."""
    import importlib
    import json

    names = {}
    for sub in ("", ".data", ".models", ".ops", ".training"):
        jmod = importlib.import_module("whisper_sae_tpu" + sub)
        names["whisper_sae_tpu_torch" + sub] = list(jmod.__all__)
    names["whisper_sae_tpu_torch.runtime"] = ["PrefetchLoader", "ShardReader", "build_native",
                                              "native_available"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", _EXPORTS, json.dumps(names)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"missing": [], "bad": [], "loaded": [], "cuda_init": False,
                   "kernels": False, "wstio": False}, out
