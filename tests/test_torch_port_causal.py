"""The port's causal interventions (``whisper_sae_tpu_torch.causal``)
against the JAX package's on the CPU: a 2+2-layer Whisper of width 64
with the JAX package's parameters (``params_from_jax``), SAEs with the
same parameters in both packages, the same numpy-seeded mel.

Bars: the identity patch equals the port's clean forward bit for bit;
patched hidden states and logits against JAX at f32 rtol 2e-4 (atol 2e-4
* max|ref|); greedy tokens equal; ``substitution_effect`` and
``feature_ablation_sweep`` KLs within 1e-4 relative, the same token
agreement and the same feature order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu import causal as jc
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu_torch import causal as tc
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models import whisper as TW
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

D, H, K, T = 64, 256, 8, 75
KW = dict(d_model=D, encoder_layers=2, decoder_layers=2, num_heads=2, ffn_dim=128, n_mels=80,
          max_source_positions=T, max_target_positions=24, vocab_size=200,
          decoder_start_token_id=42, eos_token_id=3)
JARCH, TARCH = JW.WhisperArch(**KW), TW.WhisperArch(**KW)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Whisper parameters with nonzero biases and LN params in both
    packages, and a mel batch."""
    params = JW.init_whisper(jax.random.PRNGKey(0), JARCH)
    key = jax.random.PRNGKey(3)
    params = jax.tree_util.tree_map(lambda a: a + 0.05 * jax.random.normal(key, a.shape), params)
    mel = (np.random.default_rng(1).standard_normal((2, 80, 2 * T)) * 0.5).astype(np.float32)
    tparams = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return params, tparams, jnp.asarray(mel), torch.from_numpy(mel)


@pytest.fixture(scope="module")
def saes():
    """(JAX, port) pairs with the same parameters: a TopK SAE with nonzero
    biases, and a ReLU SAE."""
    rng = np.random.default_rng(2)
    p = {k: np.asarray(v) for k, v in jsae.TopKSAE(D, H, K, seed=1).params.items()}
    p = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p.items()}
    topk = (jsae.TopKSAE(D, H, K, params={k: jnp.asarray(v) for k, v in p.items()}),
            tsae.TopKSAE(D, H, K, params=params_from_jax(p), device="cpu"))
    r = {k: np.asarray(v) for k, v in jsae.ReLUSAE(D, H, seed=2).params.items()}
    relu = (jsae.ReLUSAE(D, H, params={k: jnp.asarray(v) for k, v in r.items()}),
            tsae.ReLUSAE(D, H, params=params_from_jax(r), device="cpu"))
    return {"topk": topk, "relu": relu}


def _close(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * float(np.abs(want).max()), err_msg=what)


def _patches(kind: str, saes, params, tparams, component: str):
    """(JAX patch, port patch) of one kind."""
    if kind == "scale_shift":
        return (lambda h: h * 0.5 + 0.1), (lambda h: h * 0.5 + 0.1)
    if kind == "zero":
        return jnp.zeros_like, torch.zeros_like
    j, t = saes["relu" if kind == "relu_reconstruction" else "topk"]
    if kind in ("reconstruction", "relu_reconstruction", "reconstruction_no_ln"):
        ln = kind != "reconstruction_no_ln"
        return (jc.sae_reconstruction_patch(j, params, ln, component=component),
                tc.sae_reconstruction_patch(t, tparams, ln, component=component))
    if kind == "ablation":
        feats = [0, 5, 17, 200]
        return (jc.feature_ablation_patch(j, feats, params, component=component),
                tc.feature_ablation_patch(t, feats, tparams, component=component))
    kw = {"scale": 2.5} if kind == "steer_scale" else {"set_value": 3.0}
    return (jc.feature_steering_patch(j, [1, 9], params, component=component, **kw),
            tc.feature_steering_patch(t, [1, 9], tparams, component=component, **kw))


KINDS = ["scale_shift", "zero", "reconstruction", "relu_reconstruction", "reconstruction_no_ln",
         "ablation", "steer_scale", "steer_set"]


def test_identity_patch_is_the_clean_forward(model):
    params, tparams, jmel, tmel = model
    for layer in range(2):
        last, layers = tc.encoder_forward_patched(tparams, tmel, TARCH, layer, lambda h: h)
        clean_last, clean_layers = TW.encoder_forward(tparams, tmel, TARCH)
        assert torch.equal(last, clean_last) and torch.equal(layers, clean_layers)
        jlast, jlayers = jc.encoder_forward_patched(params, jmel, JARCH, layer, lambda h: h)
        _close(last, jlast, "encoder last")
        _close(layers, jlayers, "encoder layers")
    bos = torch.full((2, 1), TARCH.decoder_start_token_id)
    enc = clean_last
    dec_last, dec_layers = tc.decoder_forward_patched(tparams, bos, enc, TARCH, 1, lambda h: h)
    want_last, want_layers = TW.decoder_forward(tparams, bos, enc, TARCH)
    assert torch.equal(dec_last, want_last) and torch.equal(dec_layers, want_layers)
    clean = TW.decoder_logits(tparams, want_last[:, 0])
    assert torch.equal(tc.patched_logits(tparams, tmel, TARCH, 0, lambda h: h), clean)
    assert torch.equal(tc.patched_logits_decoder(tparams, tmel, TARCH, 1, lambda h: h), clean)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_encoder_patched_logits_match_jax(model, saes, kind, layer):
    params, tparams, jmel, tmel = model
    jp, tp = _patches(kind, saes, params, tparams, "encoder")
    got = tc.patched_logits(tparams, tmel, TARCH, layer, tp)
    want = jc.patched_logits(params, jmel, JARCH, layer, jp)
    _close(got, want, kind)
    if kind != "scale_shift":  # the patch moved the logits
        assert not torch.allclose(got, tc.patched_logits(tparams, tmel, TARCH, layer,
                                                         lambda h: h))
    _, layers = tc.encoder_forward_patched(tparams, tmel, TARCH, layer, tp)
    _, jlayers = jc.encoder_forward_patched(params, jmel, JARCH, layer, jp)
    _close(layers, jlayers, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_decoder_patched_logits_and_tokens_match_jax(model, saes, kind):
    params, tparams, jmel, tmel = model
    jp, tp = _patches(kind, saes, params, tparams, "decoder")
    got = tc.patched_logits_decoder(tparams, tmel, TARCH, 1, tp)
    _close(got, jc.patched_logits_decoder(params, jmel, JARCH, 1, jp), kind)
    tokens = tc.greedy_decode_patched_decoder(tparams, tmel, TARCH, 0, tp, max_len=10)
    want = jc.greedy_decode_patched_decoder(params, jmel, JARCH, 0, jp, max_len=10)
    assert tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("component", ["encoder", "decoder"])
@pytest.mark.parametrize("family", ["topk", "relu"])
def test_substitution_effect_matches_jax(model, saes, component, family):
    params, tparams, jmel, tmel = model
    j, t = saes[family]
    got = tc.substitution_effect(tparams, tmel, TARCH, t, 1, max_len=12, component=component)
    want = jc.substitution_effect(params, jmel, JARCH, j, 1, max_len=12, component=component)
    assert set(got) == {"logit_kl", "token_agreement"}
    assert got["logit_kl"] > 0 and _rel(got["logit_kl"], want["logit_kl"]) <= 1e-4, (got, want)
    assert got["token_agreement"] == want["token_agreement"]


@pytest.mark.parametrize("component", ["encoder", "decoder"])
def test_feature_ablation_sweep_matches_jax(model, saes, component):
    params, tparams, jmel, tmel = model
    j, t = saes["topk"]
    feats = [3, 40, 77, 128, 255]
    got = tc.feature_ablation_sweep(tparams, tmel, TARCH, t, 0, feats, component=component)
    want = jc.feature_ablation_sweep(params, jmel, JARCH, j, 0, feats, component=component)
    assert [r["feature_idx"] for r in got] == [r["feature_idx"] for r in want]
    for g, w in zip(got, want):
        assert _rel(g["logit_kl"], w["logit_kl"]) <= 1e-4, (g, w)
    m = [r["marginal_logit_kl"] for r in got]
    assert m == sorted(m, reverse=True)


def test_reconstruction_leaves_the_sae_state(model, saes):
    """The substitution reconstructs through ``topk_sae_apply`` on the
    SAE's parameters, never its training-mode ``forward``: the
    dead-feature counters stay as they were."""
    _, tparams, _, tmel = model
    _, t = saes["topk"]
    t.train(True)
    before = (t.feature_last_activated.clone(), t.step_count.clone())
    tc.substitution_effect(tparams, tmel, TARCH, t, 0, max_len=4)
    assert torch.equal(t.feature_last_activated, before[0])
    assert torch.equal(t.step_count, before[1])
    t.train(False)


def test_metrics_and_argument_checks(model, saes):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 3, 50)).astype(np.float32)
    np.testing.assert_allclose(float(tc.logit_kl(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jc.logit_kl(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    ta, tb = rng.integers(0, 3, (2, 4, 6))
    assert float(tc.token_agreement(torch.from_numpy(ta), torch.from_numpy(tb))) == \
        float(jc.token_agreement(jnp.asarray(ta), jnp.asarray(tb)))
    _, tparams, _, _ = model
    with pytest.raises(ValueError, match="exactly one"):
        tc.feature_steering_patch(saes["topk"][1], [0], tparams)
    with pytest.raises(ValueError, match="exactly one"):
        tc.feature_steering_patch(saes["topk"][1], [0], tparams, scale=1.0, set_value=0.0)
