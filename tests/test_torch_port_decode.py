"""The port's greedy decoding (``models/whisper.py``: ``greedy_decode_cached``,
``greedy_decode``, the cached step) against the JAX package's, on the CPU,
from the same parameters (``params_from_jax``), and against HF ``generate``.

Bars: f32 tokens bit for bit; f32 step logits at rtol 1e-4, atol 1e-5;
bf16 against the JAX fused encoder in Pallas interpret mode at the stack
bar (max|d| <= 2**-4 * max|ref|, mean|d| <= 2**-7 * mean|ref|) for the
encoder hidden and the teacher-forced step logits, a differing argmax
only where JAX's top-1 to top-2 gap is under twice the step's max
|d logit|.
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
from whisper_sae_tpu_torch.ops import encoder as E

D, HEADS, F, T = 128, 2, 256, 100
START, EOS = 1, 2
BF = jnp.bfloat16
STACK_MAX, STACK_MEAN = 2.0**-4, 2.0**-7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arches():
    # 16 target positions: room for max_len 12 and HF's 12 new tokens
    kw = dict(d_model=D, encoder_layers=2, decoder_layers=2, num_heads=HEADS, ffn_dim=F,
              n_mels=80, max_source_positions=T, max_target_positions=16, vocab_size=64,
              decoder_start_token_id=START, eos_token_id=EOS)
    return JW.WhisperArch(**kw), TW.WhisperArch(**kw)


@pytest.fixture(scope="module")
def model():
    """Parameters with nonzero biases and LN params in both packages, and a
    mel batch."""
    jarch, tarch = _arches()
    params = JW.init_whisper(jax.random.PRNGKey(0), jarch)
    key = jax.random.PRNGKey(3)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * jax.random.normal(key, a.shape), params)
    mel = (np.random.default_rng(1).standard_normal((2, 80, 2 * T)) * 0.5).astype(np.float32)
    tparams = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jarch, tarch, params, tparams, mel


def _jax_tokens(params, mel, jarch, max_len, forced=None, **kw):
    return np.asarray(JW.greedy_decode_cached(params, jnp.asarray(mel), jarch, max_len=max_len,
                                              forced_ids=forced, **kw))


def _frozen(tokens: np.ndarray) -> np.ndarray:
    """``[B, max_len - 1]``: the steps whose token the EOS freeze set (the
    row emitted EOS at an earlier step)."""
    hit = np.cumsum(tokens[:, 1:] == EOS, axis=1)
    return np.concatenate([np.zeros((tokens.shape[0], 1), bool), hit[:, :-1] > 0], axis=1)


@pytest.mark.parametrize("forced", [None, (7, 11, 13), (7, EOS)], ids=["free", "forced", "eos"])
@pytest.mark.parametrize("max_len", [8, 12])
def test_f32_tokens_bit_equal_jax(model, max_len, forced):
    jarch, tarch, params, tparams, mel = model
    want = _jax_tokens(params, mel, jarch, max_len, forced)
    mel_t = torch.from_numpy(mel)
    cached = TW.greedy_decode_cached(tparams, mel_t, tarch, max_len=max_len, forced_ids=forced)
    uncached = TW.greedy_decode(tparams, mel_t, tarch, max_len=max_len, forced_ids=forced)
    assert cached.dtype == torch.int32 and tuple(cached.shape) == (2, max_len)
    np.testing.assert_array_equal(cached.numpy(), want)
    np.testing.assert_array_equal(uncached.numpy(), want)
    assert (want[:, 0] == START).all()
    if forced:
        assert (want[:, 1:1 + len(forced)] == forced).all()
    if forced and EOS in forced:  # the freeze: EOS forced at position 2, EOS ever after
        assert (want[:, 2:] == EOS).all()


def test_step_logits_match_jax_teacher_forced(model):
    """Each cached step along JAX's tokens against JAX's full decoder on
    the prefix, ``decoder_logits(decoder_forward(...)[0][:, t])``."""
    jarch, tarch, params, tparams, mel = model
    max_len = 12
    jtok = _jax_tokens(params, mel, jarch, max_len)
    jenc = JW.encoder_forward(params, jnp.asarray(mel), jarch)[0]
    with torch.no_grad(), TW.f32_matmuls():
        tenc = TW.encoder_forward(tparams, torch.from_numpy(mel), tarch)[0]
        state = TW._decode_state(tparams, tarch, tenc, max_len)
        tok = torch.tensor(jtok, dtype=torch.long)
        for t in range(max_len - 1):
            got = TW._decode_step(tparams, tarch, state, tok[:, t], t)
            hid = JW.decoder_forward(params, jnp.asarray(jtok[:, :t + 1]), jenc, jarch)[0]
            want = np.asarray(JW.decoder_logits(params, hid[:, t]))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=f"t={t}")


def test_next_token_takes_the_first_maximum_then_forcing_then_freeze():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 0.0, 5.0], [0.0, 0.0, 0.0, 9.0]])
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)),
                                  [1, 0, 3])
    finished = torch.tensor([False, False, True])
    assert TW._next_token(logits, -1, finished, EOS).tolist() == [1, 0, EOS]
    finished = torch.tensor([False, False, True])
    assert TW._next_token(logits, EOS, finished, EOS).tolist() == [EOS, EOS, EOS]
    assert finished.tolist() == [True, True, True]
    buf = TW._forced_buffer((7, 11, 13), 3)
    assert buf.dtype == np.int32
    np.testing.assert_array_equal(buf, np.asarray(JW._forced_buffer((7, 11, 13), 3)))
    np.testing.assert_array_equal(TW._forced_buffer(None, 5), np.full(5, -1, np.int32))


def _jax_cached_logits(jp, jarch, jenc, jtok, monkeypatch) -> np.ndarray:
    """JAX's own cached decode teacher-forced along ``jtok`` by its forcing
    (every position forced, a row at a time), each step's logits shipped
    out of the jitted loop: ``[max_len - 1, B, V]``."""
    seen: list[np.ndarray] = []
    logits_of = JW.decoder_logits

    def spy(params, hidden):
        logits = logits_of(params, hidden)
        jax.debug.callback(lambda v: seen.append(np.asarray(v, np.float32)), logits, ordered=True)
        return logits

    monkeypatch.setattr(JW, "decoder_logits", spy)
    decode = jax.jit(JW.greedy_decode_cached.__wrapped__,  # a fresh trace sees the spy
                     static_argnames=("arch", "max_len", "forced_ids"))
    rows = []
    for r in range(jtok.shape[0]):
        seen.clear()
        toks = decode(jp, None, jarch, max_len=jtok.shape[1], encoder_hidden=jenc[r:r + 1],
                      forced_ids=tuple(int(v) for v in jtok[r, 1:]))
        np.testing.assert_array_equal(np.asarray(toks)[0], jtok[r])
        rows.append(np.concatenate(seen))
    monkeypatch.setattr(JW, "decoder_logits", logits_of)
    return np.stack(rows, axis=1)


def test_bf16_decode_matches_fused_jax(model, monkeypatch):
    """bf16 weights and mel: JAX's cached decode over its fused encoder
    (both Pallas gates forced on, interpret mode) against the port on the
    CPU (the fused route's plain versions).  The step logits are held
    against JAX's cached route, whose residual adds round in the same
    order (``(h + y @ wo) + bo``; ``decoder_forward`` rounds ``h + (y @ wo
    + bo)``, which alone moves bf16 logits by ~2**-7 here)."""
    jarch, tarch, params, tparams, mel = model
    max_len = 12
    jp = jax.tree_util.tree_map(lambda a: a.astype(BF), params)
    monkeypatch.setattr(JW, "_use_fused_encoder", lambda *a: True)
    monkeypatch.setattr(pe, "supported", lambda *a: True)
    monkeypatch.setattr(pe, "stem_supported", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        jenc = JW.encoder_forward(jp, jnp.asarray(mel, BF), jarch)[0]
    jtok = np.asarray(JW.greedy_decode_cached(jp, None, jarch, max_len=max_len,
                                              encoder_hidden=jenc))
    want = _jax_cached_logits(jp, jarch, jenc, jtok, monkeypatch)
    tp = TW.cast_params(tparams, torch.bfloat16)
    E.plain_calls.clear()
    with torch.no_grad(), TW.f32_matmuls():
        tenc = TW.encoder_forward(tp, torch.from_numpy(mel).bfloat16(), tarch)[0]
        assert E.plain_calls["conv_stem"] == 1 and E.plain_calls["mlp_block"] == 2
        assert tenc.dtype == torch.bfloat16
        _stack_close(tenc[None].float(), np.asarray(jenc, np.float32)[None], "encoder hidden")
        state = TW._decode_state(tp, tarch, tenc, max_len)
        tok = torch.tensor(jtok, dtype=torch.long)
        got = torch.stack([TW._decode_step(tp, tarch, state, tok[:, t], t)
                           for t in range(max_len - 1)]).numpy()
    free = TW.greedy_decode_cached(tp, None, tarch, max_len=max_len, encoder_hidden=tenc)
    assert free.dtype == torch.int32 and (free[:, 0] == START).all()
    _stack_close(got, want, "step logits")
    frozen = _frozen(jtok).T
    top2 = np.sort(want, axis=-1)[..., -2:]
    for t, r in zip(*np.nonzero((got.argmax(-1) != jtok[:, 1:].T) & ~frozen)):
        gap, delta = float(top2[t, r, 1] - top2[t, r, 0]), float(np.abs(got[t, r] - want[t, r]).max())
        print(f"step {t} row {r}: port {got[t, r].argmax()} jax {jtok[r, t + 1]}, "
              f"gap {gap:.3g}, max |d logit| {delta:.3g}")
        assert gap < 2 * delta, (t, r, gap, delta)


def _stack_close(got, want, what=""):
    """The stack bar along the leading axis."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all(), (what, g.shape, w.shape)
    for i in range(g.shape[0]):
        d = np.abs(g[i] - w[i])
        mx, mn = float(d.max() / np.abs(w[i]).max()), float(d.mean() / np.abs(w[i]).mean())
        print(f"{what}[{i}]: max rel {mx:.3g}, mean rel {mn:.3g}")
        assert mx <= STACK_MAX and mn <= STACK_MEAN, (what, i, mx, mn)


class TestHFGenerate:
    """Token for token against HF ``generate(do_sample=False)`` on the same
    random torch Whisper, aligned as ``tests/test_whisper.py`` aligns the
    JAX package."""

    MAX_NEW = 12

    @pytest.fixture(scope="class")
    def hf(self):
        transformers = pytest.importorskip("transformers")
        cfg = transformers.WhisperConfig(
            vocab_size=64, num_mel_bins=80, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=HEADS, decoder_attention_heads=HEADS, d_model=D,
            encoder_ffn_dim=F, decoder_ffn_dim=F, max_source_positions=T,
            max_target_positions=20, decoder_start_token_id=START, eos_token_id=EOS,
            pad_token_id=0, bos_token_id=START)
        torch.manual_seed(0)
        model = transformers.WhisperForConditionalGeneration(cfg).eval()
        arch = TW.WhisperArch(D, 2, 2, HEADS, F, n_mels=80, max_source_positions=T,
                              max_target_positions=20, vocab_size=64,
                              decoder_start_token_id=START, eos_token_id=EOS)
        return model, TW.from_hf_state_dict(model.state_dict(), arch), arch

    def _hf_tokens(self, model, mel, forced=None):
        kwargs = {}
        if forced is not None:  # the primed prompt stands for forced_decoder_ids
            kwargs["decoder_input_ids"] = torch.tensor([[START, *forced]] * mel.shape[0])
        with torch.no_grad():
            out = model.generate(input_features=torch.from_numpy(mel), do_sample=False,
                                 max_new_tokens=self.MAX_NEW, suppress_tokens=None,
                                 begin_suppress_tokens=None, **kwargs)
        return np.asarray(out)

    @staticmethod
    def _mask_after_eos(toks):
        toks = toks.copy()
        for r in range(toks.shape[0]):
            hits = np.where(toks[r] == EOS)[0]
            if len(hits):
                toks[r, hits[0]:] = EOS
        return toks

    @pytest.mark.parametrize("forced", [None, (7, 11, 13)], ids=["free", "forced"])
    def test_tokens_match_hf_generate(self, hf, model, forced):
        hf_model, params, arch = hf
        mel = model[4]
        want = self._hf_tokens(hf_model, mel, forced)
        n_prompt = 1 + len(forced or ())
        ours = TW.greedy_decode_cached(params, torch.from_numpy(mel), arch,
                                       max_len=self.MAX_NEW + n_prompt,
                                       forced_ids=forced).numpy()
        assert (ours[:, 0] == START).all()
        ours = ours[:, n_prompt:]
        if forced is None and want.shape[1] == self.MAX_NEW + 1:  # HF kept the start token
            assert (want[:, 0] == START).all()
            want = want[:, 1:]
        n = min(want.shape[1], ours.shape[1])
        np.testing.assert_array_equal(self._mask_after_eos(ours[:, :n]),
                                      self._mask_after_eos(want[:, :n]))
