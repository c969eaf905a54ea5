"""The port's capture facades (``models/hooks.py``) and decoder analysis
(``decoder_analysis/``) against the JAX package's, on the CPU, from the
same parameters (``params_from_jax``).

Bars: f32 at rtol 1e-4, atol 1e-5 (the cross-attention maps at atol
1e-6), token ids equal; bf16 captures against the JAX fused encoder in
Pallas interpret mode at the stack bar (max|d| <= 2**-4 * max|ref|,
mean|d| <= 2**-7 * mean|ref|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu import decoder_analysis as JD
from whisper_sae_tpu.models import hooks as JH
from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.ops import pallas_encoder as pe
from whisper_sae_tpu_torch import decoder_analysis as TD
from whisper_sae_tpu_torch.models import hooks as TH
from whisper_sae_tpu_torch.models import whisper as TW

D, HEADS, F, T = 128, 2, 256, 100
BF = jnp.bfloat16
STACK_MAX, STACK_MEAN = 2.0**-4, 2.0**-7
TOKENS = np.array([[1, 5, 9], [1, 7, 3]])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Parameters with nonzero biases and LN params in both packages, and a
    mel batch."""
    kw = dict(d_model=D, encoder_layers=2, decoder_layers=2, num_heads=HEADS, ffn_dim=F,
              n_mels=80, max_source_positions=T, max_target_positions=8, vocab_size=64,
              decoder_start_token_id=1, eos_token_id=2)
    jarch, tarch = JW.WhisperArch(**kw), TW.WhisperArch(**kw)
    params = JW.init_whisper(jax.random.PRNGKey(0), jarch)
    key = jax.random.PRNGKey(3)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * jax.random.normal(key, a.shape), params)
    mel = (np.random.default_rng(1).standard_normal((2, 80, 2 * T)) * 0.5).astype(np.float32)
    tparams = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jarch, tarch, params, tparams, mel


def _stack_close(got, want, what):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all(), (what, g.shape, w.shape)
    d = np.abs(g - w)
    mx, mn = float(d.max() / np.abs(w).max()), float(d.mean() / np.abs(w).mean())
    print(f"{what}: max rel {mx:.3g}, mean rel {mn:.3g}")
    assert mx <= STACK_MAX and mn <= STACK_MEAN, (what, mx, mn)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_extract_features_batch_matches_jax(model, monkeypatch, dtype):
    jarch, tarch, params, tparams, mel = model
    enc_layers, dec_layers = [0, 1], [1]
    if dtype == "f32":
        want = JH.extract_features_batch(params, jarch, mel, enc_layers, dec_layers)
    else:  # the JAX fused path (both Pallas gates forced on, interpret mode), sliced
        monkeypatch.setattr(JW, "_use_fused_encoder", lambda *a: True)
        monkeypatch.setattr(pe, "supported", lambda *a: True)
        monkeypatch.setattr(pe, "stem_supported", lambda *a: True)
        with pltpu.force_tpu_interpret_mode():
            out = JW.extract_activations.__wrapped__(params, jnp.asarray(mel), jarch,
                                                     compute_dtype=BF)
        want = {"encoder": {i: np.asarray(out["encoder"][i]) for i in enc_layers},
                "decoder": {i: np.asarray(out["decoder"][i]) for i in dec_layers}}
    got = TH.extract_features_batch(tparams, tarch, mel, enc_layers, dec_layers,
                                    compute_dtype=None if dtype == "f32" else torch.bfloat16)
    assert set(got) == {"encoder", "decoder"}
    for comp, layers in (("encoder", enc_layers), ("decoder", dec_layers)):
        assert sorted(got[comp]) == layers
        for i in layers:
            g, w = got[comp][i], np.asarray(want[comp][i])
            assert isinstance(g, np.ndarray) and g.dtype == np.float32 and g.shape == w.shape
            if dtype == "f32":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"{comp}:{i}")
            else:
                _stack_close(g, w, f"{comp}:{i}")


def test_activation_cache_and_extractor(model, monkeypatch):
    """Two captures concatenate along the batch axis; an uncaptured layer
    is None; the hook calls do nothing; a decoder not asked for is not run."""
    _, tarch, _, tparams, mel = model
    calls = []
    real = TH.extract_activations

    def spy(*args, **kwargs):
        calls.append(kwargs["with_decoder"])
        return real(*args, **kwargs)

    monkeypatch.setattr(TH, "extract_activations", spy)
    ex = TH.WhisperActivationExtractor(tparams, tarch, encoder_layers=[1])
    with ex:
        assert ex.register_hooks() is None
        ex.capture(mel)
        ex.capture(torch.from_numpy(mel[:1]))
        assert ex.remove_hooks() is None
    assert calls == [False, False]
    acts = ex.cache.get_encoder_activations(1)
    assert acts.shape == (3, T, D)
    np.testing.assert_array_equal(acts[:2], TH.extract_features_batch(tparams, tarch, mel, [1])
                                  ["encoder"][1])
    np.testing.assert_array_equal(acts[2:], TH.extract_features_batch(tparams, tarch, mel[:1], [1])
                                  ["encoder"][1])
    assert ex.cache.get_encoder_activations(0) is None
    assert ex.cache.get_decoder_activations(1) is None and ex.cache.decoder == {}
    ex.clear_cache()
    assert ex.cache.get_encoder_activations(1) is None
    assert TH.extract_features_batch(tparams, tarch, mel, [0], [1])["decoder"][1].shape == (2, 1, D)
    assert calls[-1] is True


@pytest.mark.parametrize("tokens", [None, TOKENS], ids=["start", "prompt"])
def test_logit_lens_matches_jax(model, tokens):
    jarch, tarch, params, tparams, mel = model
    want = JD.logit_lens(params, jnp.asarray(mel), jarch,
                         token_ids=None if tokens is None else jnp.asarray(tokens))
    got = TD.logit_lens(tparams, torch.from_numpy(mel), tarch,
                        token_ids=None if tokens is None else torch.from_numpy(tokens))
    assert got["token_ids"].dtype == torch.int32 and tuple(got["token_ids"].shape) == (2, 2, 5)
    np.testing.assert_array_equal(got["token_ids"].numpy(), np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=1e-4)
    np.testing.assert_allclose(got["logits_last"].numpy(), np.asarray(want["logits_last"]),
                               rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        mel_t = torch.from_numpy(mel)
        enc = TW.encoder_forward(tparams, mel_t, tarch)[0]
        ids = torch.full((2, 1), 1) if tokens is None else torch.from_numpy(tokens)
        last = TW.decoder_forward(tparams, ids, enc, tarch)[0][:, -1]
    assert torch.equal(got["logits_last"], TW.decoder_logits(tparams, last))
    agree = TD.lens_agreement(got)
    np.testing.assert_allclose(agree.numpy(), np.asarray(JD.lens_agreement(want)), rtol=1e-6)
    assert float(agree[-1]) == 1.0


@pytest.mark.parametrize("tokens", [None, TOKENS], ids=["start", "prompt"])
def test_cross_attention_maps_match_jax(model, tokens):
    jarch, tarch, params, tparams, mel = model
    want = JD.cross_attention_maps(params, jnp.asarray(mel), jarch,
                                   token_ids=None if tokens is None else jnp.asarray(tokens))
    got = TD.cross_attention_maps(tparams, torch.from_numpy(mel), tarch,
                                  token_ids=None if tokens is None else torch.from_numpy(tokens))
    t_dec = 1 if tokens is None else tokens.shape[1]
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, HEADS, t_dec, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_array_equal(TD.top_attended_frames(got, 5).numpy(),
                                  np.asarray(JD.top_attended_frames(want, 5)))
    np.testing.assert_allclose(TD.attention_entropy(got).numpy(),
                               np.asarray(JD.attention_entropy(want)), rtol=1e-4)
