"""The port's Whisper forward and capture (``models/whisper.py``) against the
JAX package's, on the CPU, from the same parameters (``params_from_jax``).

Bars: the f32 parity mode against the JAX composed f32 path at rtol
1e-4, atol 1e-5 (TF32 off, same algebra); bf16 against the JAX fused
path in Pallas interpret mode, per captured layer, max|d| <= 2**-4 *
max|ref| and mean|d| <= 2**-7 * mean|ref| (a stack of bf16 blocks); one
bf16 attention sublayer at the one-block bar, 2**-6 and 2**-9.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.ops import pallas_encoder as pe
from whisper_sae_tpu_torch.models import whisper as TW

transformers = pytest.importorskip("transformers")

D, HEADS, F, T = 128, 2, 256, 100
BF = jnp.bfloat16
STACK_MAX, STACK_MEAN = 2.0**-4, 2.0**-7

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs one worker process per core: keep torch's intra-op
    pool to one thread here, or the workers' pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _arches(layers: int = 2):
    kw = dict(d_model=D, encoder_layers=layers, decoder_layers=layers, num_heads=HEADS,
              ffn_dim=F, n_mels=80, max_source_positions=T, max_target_positions=8,
              vocab_size=64, decoder_start_token_id=1, eos_token_id=2)
    return JW.WhisperArch(**kw), TW.WhisperArch(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """Parameters with nonzero biases and LN params, in both packages, and
    a mel batch."""
    jarch, tarch = _arches()
    params = JW.init_whisper(jax.random.PRNGKey(0), jarch)
    key = jax.random.PRNGKey(3)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * jax.random.normal(key, a.shape), params)
    mel = (np.random.default_rng(1).standard_normal((2, 80, 2 * T)) * 0.5).astype(np.float32)
    return jarch, tarch, params, TW.params_from_jax(_np_tree(params)), mel


def _f32_close(got, want, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-5, err_msg=what)


def _stack_close(got, want, what=""):
    """The stack bar, per captured layer (leading axis of ``[L, ...]``)."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    for i in range(g.shape[0]):
        d = np.abs(g[i] - w[i])
        mx, mn = float(d.max() / np.abs(w[i]).max()), float(d.mean() / np.abs(w[i]).mean())
        print(f"{what}[{i}]: max rel {mx:.3g}, mean rel {mn:.3g}")
        assert mx <= STACK_MAX and mn <= STACK_MEAN, (what, i, mx, mn)


def test_params_from_jax_round_trip(model):
    _, _, params, tparams, _ = model
    flat_j = jax.tree_util.tree_flatten_with_path(_np_tree(params))[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in flat_j:
        node = tparams
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32 and tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    bf = TW.params_from_jax({"w": np.asarray(jnp.ones((3, 2), BF) * 1.5)})["w"]
    assert bf.dtype == torch.bfloat16 and bool((bf == 1.5).all())


def test_init_whisper_matches_jax_tree():
    jarch, tarch = _arches(layers=3)
    want = jax.tree_util.tree_map(lambda a: a.shape, JW.init_whisper(jax.random.PRNGKey(0), jarch))
    got = TW._tree_map(lambda a: tuple(a.shape), TW.init_whisper(torch.Generator().manual_seed(0),
                                                                 tarch))
    assert got == want
    np.testing.assert_allclose(TW._sinusoids(T, D), JW._sinusoids(T, D), rtol=0, atol=0)


@pytest.fixture(scope="module")
def hf():
    """A random HF Whisper at the small geometry."""
    cfg = transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=80, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS, d_model=D,
        encoder_ffn_dim=F, decoder_ffn_dim=F, max_source_positions=T, max_target_positions=8,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=0, bos_token_id=1)
    torch.manual_seed(0)
    return transformers.WhisperForConditionalGeneration(cfg).eval()


def test_from_hf_state_dict_matches_from_hf_torch(hf):
    want, jarch = JW.from_hf_torch(hf)
    got = TW.from_hf_state_dict(hf.state_dict(), TW.WhisperArch(**vars(jarch)))
    flat = jax.tree_util.tree_flatten_with_path(_np_tree(want))[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))


@pytest.mark.parametrize("safetensors", [False, True])
def test_load_pretrained_from_a_local_snapshot(hf, tmp_path, monkeypatch, safetensors):
    hf.save_pretrained(tmp_path / "snap", safe_serialization=safetensors)
    params, arch = TW.load_pretrained("openai/whisper-tiny", path=tmp_path / "snap")
    assert (arch.d_model, arch.encoder_layers, arch.num_heads, arch.vocab_size) == (D, 2, HEADS, 64)
    want = TW.from_hf_state_dict(hf.state_dict(), arch)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        TW.load_pretrained("openai/whisper-tiny")


def test_encoder_and_decoder_forward_f32(model):
    jarch, tarch, params, tparams, mel = model
    j_last, j_layers, (j_min, j_mout) = JW.encoder_forward(params, jnp.asarray(mel), jarch,
                                                           with_mlp=True, capture_final_ln=True)
    with torch.no_grad():
        t_last, t_layers, (t_min, t_mout) = TW.encoder_forward(
            tparams, torch.from_numpy(mel), tarch, with_mlp=True, capture_final_ln=True)
    for what, g, w in [("last", t_last, j_last), ("layers", t_layers, j_layers),
                       ("mlp_in", t_min, j_min), ("mlp_out", t_mout, j_mout)]:
        _f32_close(g, w, what)
    tokens = np.array([[1, 5, 9], [1, 7, 3]])
    jd = JW.decoder_forward(params, jnp.asarray(tokens), j_last, jarch, with_mlp=True)
    with torch.no_grad():
        td = TW.decoder_forward(tparams, torch.from_numpy(tokens), t_last, tarch, with_mlp=True)
    _f32_close(td[0], jd[0], "decoder last")
    _f32_close(td[1], jd[1], "decoder layers")
    _f32_close(td[2][0], jd[2][0], "decoder mlp_in")
    _f32_close(td[2][1], jd[2][1], "decoder mlp_out")


@pytest.mark.parametrize("apply_layer_norm", [True, False])
def test_extract_activations_f32(model, apply_layer_norm):
    jarch, tarch, params, tparams, mel = model
    want = JW.extract_activations(params, jnp.asarray(mel), jarch, with_mlp=True,
                                  apply_layer_norm=apply_layer_norm)
    got = TW.extract_activations(tparams, torch.from_numpy(mel), tarch, with_mlp=True,
                                 apply_layer_norm=apply_layer_norm)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        _f32_close(got[k], want[k], k)


@pytest.mark.parametrize("with_mlp,apply_layer_norm,capture", [
    (True, True, "bf16"), (False, True, "f32"), (True, False, "bf16"),
])
def test_extract_activations_bf16_matches_fused_jax(model, monkeypatch, with_mlp,
                                                    apply_layer_norm, capture):
    """bf16 compute against the JAX fused path (both Pallas gates forced
    on, interpret mode), as ``tests/test_pallas_encoder.py`` drives it."""
    jarch, tarch, params, tparams, mel = model
    jcap, tcap = (BF, torch.bfloat16) if capture == "bf16" else (None, None)
    monkeypatch.setattr(JW, "_use_fused_encoder", lambda *a: True)
    monkeypatch.setattr(pe, "supported", lambda *a: True)
    monkeypatch.setattr(pe, "stem_supported", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        want = JW.extract_activations.__wrapped__(
            params, jnp.asarray(mel), jarch, compute_dtype=BF, with_mlp=with_mlp,
            apply_layer_norm=apply_layer_norm, capture_dtype=jcap)
    got = TW.extract_activations(tparams, torch.from_numpy(mel), tarch,
                                 compute_dtype=torch.bfloat16, with_mlp=with_mlp,
                                 apply_layer_norm=apply_layer_norm, capture_dtype=tcap)
    assert set(got) == set(want)
    for k in want:
        want_dt = torch.float32 if k == "encoder_last" or capture == "f32" else torch.bfloat16
        assert got[k].dtype == want_dt, k
        w = want[k] if want[k].ndim == 4 else want[k][None]
        _stack_close(got[k] if got[k].dim() == 4 else got[k][None], w, k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_few_query_cross_attention(model, dtype):
    """The reassociated BOS cross-attention (tq=1 against T encoder rows)."""
    jarch, _, params, tparams, _ = model
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 1, D)).astype(np.float32)
    enc = rng.standard_normal((2, T, D)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["decoder"]["layers"]["xattn"])
    tp = TW._layer(tparams["decoder"]["layers"]["xattn"], 0)
    if dtype == "bf16":
        jp = jax.tree_util.tree_map(lambda a: a.astype(BF), jp)
        tp = TW.cast_params(tp, torch.bfloat16)
    jdt, tdt = (BF, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    want = JW._attention(jnp.asarray(h, jdt), jnp.asarray(enc, jdt), jp, HEADS, causal=False)
    with torch.no_grad():
        got = TW._attention(torch.from_numpy(h).to(tdt), torch.from_numpy(enc).to(tdt), tp,
                            HEADS, causal=False)
    assert got.dtype == tdt and tuple(got.shape) == (2, 1, D)
    if dtype == "f32":
        _f32_close(got, want)
    else:
        _stack_close(got[None], np.asarray(want, np.float32)[None], "cross-attention bf16")


def test_flash_route_self_attention_bf16(model):
    """bf16 non-causal self-attention at tq == tk >= 256 runs its core
    through the attention kernel's plain version on the CPU; JAX's CPU
    path runs the composed core.  One-block bar."""
    _, _, params, tparams, _ = model
    t = 300
    x = np.random.default_rng(6).standard_normal((2, t, D)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0].astype(BF), params["encoder"]["layers"]["attn"])
    tp = TW.cast_params(TW._layer(tparams["encoder"]["layers"]["attn"], 0), torch.bfloat16)
    want = np.asarray(JW._attention(jnp.asarray(x, BF), jnp.asarray(x, BF), jp, HEADS,
                                    causal=False), np.float32)
    from whisper_sae_tpu_torch.ops import encoder as E

    E.plain_calls.clear()
    with torch.no_grad():
        xt = torch.from_numpy(x).bfloat16()
        got = TW._attention(xt, xt, tp, HEADS, causal=False).float().numpy()
    assert E.plain_calls["self_attention"] == 1
    d = np.abs(got - want)
    mx, mn = float(d.max() / np.abs(want).max()), float(d.mean() / np.abs(want).mean())
    print(f"flash route: max rel {mx:.3g}, mean rel {mn:.3g}")
    assert mx <= 2.0**-6 and mn <= 2.0**-9


def test_flatten_activations():
    acts = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(TW.flatten_activations(acts, "decoder"), acts.reshape(6, 4))
