"""The port's ReLU SAE, transcoders and crosscoders against the JAX
package's, on the CPU, from the same parameters (``params_from_jax``).

- ``*_apply`` and ``*_loss`` in f32 at rtol 1e-5.
- Trainer trajectories with the same batch order (explicit permutations
  through ``train_epoch_fused``): 2 epochs of 3 fused steps plus a
  16-row remainder step.  Under AMP the JAX trainers take their windowed
  Pallas coder kernels (interpret mode) and the port the coder kernel's
  plain version at a row offset.  Bars: f32 loss at rtol 2e-4 and final
  parameters at atol 2e-4; AMP loss at rtol 1e-3 (the bars of
  ``tests/test_torch_port_trainer.py``: the bf16 products are summed in
  another order by XLA and by torch).
- The transcoder's paired resample, the crosscoder's flat renorm and
  ``get_cross_layer_features`` against the JAX facades.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models import crosscoder as jxc
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.models import transcoder as jtc
from whisper_sae_tpu.ops import pallas_sae
from whisper_sae_tpu.training import coder_trainers as jct
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models import crosscoder as txc
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models import transcoder as ttc
from whisper_sae_tpu_torch.training import coder_trainers as tct
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

D, H, K, B = 64, 256, 8, 64
L = 2
N = 3 * B + 16
EPOCHS = 2
SW = 0.01
FAMILIES = ("relu_sae", "topk_transcoder", "skip_transcoder", "topk_crosscoder",
            "relu_crosscoder")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(family: str, seed: int) -> dict[str, np.ndarray]:
    """JAX-layout parameters drawn with numpy; the Skip transcoder's
    decoder and skip are nonzero so that every term is exercised."""
    rng = np.random.default_rng(seed)

    def u(shape, fan):
        return rng.uniform(-1, 1, shape) / np.sqrt(fan)

    if family.endswith("crosscoder"):
        w_dec = rng.standard_normal((H, L, D))
        w_dec = 0.1 * w_dec / np.linalg.norm(w_dec.reshape(H, -1), axis=1)[:, None, None]
        p = {"w_enc": np.transpose(w_dec, (1, 2, 0)) * 3, "b_enc": u(H, D) * 0.1,
             "w_dec": w_dec, "b_dec": u((L, D), D) * 0.1}
    else:
        w_dec = rng.standard_normal((H, D))
        p = {"w_enc": u((D, H), D), "b_enc": u(H, D),
             "w_dec": w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True),
             "b_dec": u(D, H)}
        if family == "skip_transcoder":
            p.update(w_skip=u((D, D), D) * 0.3, b_skip=u(D, D) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _data(family: str, seed: int):
    rng = np.random.default_rng(seed)
    if family.endswith("crosscoder"):
        return rng.standard_normal((N, L, D)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    if family.endswith("transcoder"):
        y = (np.tanh(x @ rng.standard_normal((D, D)) / np.sqrt(D)) + 0.1
             * rng.standard_normal((N, D))).astype(np.float32)
        return x, y
    return x


def _models(family: str, params: dict, threshold: int = 10_000):
    """(JAX facade, port facade on the CPU) from the same parameters."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_jax(params)
    if family == "relu_sae":
        return jsae.ReLUSAE(D, H, params=jp), tsae.ReLUSAE(D, H, params=tp, device="cpu")
    if family.endswith("transcoder"):
        skip = family == "skip_transcoder"
        j = jtc.create_transcoder(D, D, H, k=K, use_skip=skip, params=jp,
                                  dead_feature_threshold=threshold)
        t = ttc.create_transcoder(D, D, H, k=K, use_skip=skip, params=tp,
                                  dead_feature_threshold=threshold, device="cpu")
        return j, t
    topk = family == "topk_crosscoder"
    return (jxc.create_crosscoder(D, L, H, k=K, use_topk=topk, params=jp),
            txc.create_crosscoder(D, L, H, k=K, use_topk=topk, params=tp, device="cpu"))


def _both(data):
    if isinstance(data, tuple):
        return tuple(jnp.asarray(a) for a in data), tuple(torch.from_numpy(a) for a in data)
    return jnp.asarray(data), torch.from_numpy(data)


def _close(got: torch.Tensor, want, rtol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(np.asarray(want)))), err_msg=what)


@pytest.mark.parametrize("family", FAMILIES)
def test_apply_and_loss_match_jax_in_f32(family):
    params = _params(family, 1)
    (jd, td) = _both(_data(family, 2))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = params_from_jax(params)
    if family == "relu_sae":
        jo, ja = jsae.relu_sae_apply(jparams, jd[:B], SW)
        to, ta = tsae.relu_sae_apply(tparams, td[:B], SW)
        pairs = [(to.reconstructed, jo.reconstructed), (to.hidden, jo.hidden)]
        jl, jaux = jsae.relu_sae_loss(jparams, jd[:B], SW)
        tl, taux = tsae.relu_sae_loss(tparams, td[:B], SW)
    elif family.endswith("transcoder"):
        (jx, jy), (tx, ty) = jd, td
        jo, ja = jtc.transcoder_apply(jparams, jx[:B], jy[:B], K)
        to, ta = ttc.transcoder_apply(tparams, tx[:B], ty[:B], K)
        pairs = [(to.predicted, jo.predicted), (to.hidden, jo.hidden)]
        jl, jaux = jtc.transcoder_loss(jparams, jx[:B], jy[:B], K)
        tl, taux = ttc.transcoder_loss(tparams, tx[:B], ty[:B], K)
    else:
        k = K if family == "topk_crosscoder" else None
        jacts, tacts = jnp.transpose(jd[:B], (1, 0, 2)), td[:B].transpose(0, 1)
        jo = jxc.crosscoder_apply(jparams, jacts, k=k, sparsity_weight=SW)
        to = txc.crosscoder_apply(tparams, tacts, k=k, sparsity_weight=SW)
        pairs = list(zip(to[:2], jo[:2]))
        jo, to = (jo[1], *jo[2:]), (to[1], *to[2:])
        ja, ta = jnp.any(jo[0] > 0, axis=0), (to[0] > 0).any(dim=0)
        jl, jaux = jxc.crosscoder_loss(jparams, jacts, k=k, sparsity_weight=SW)
        tl, taux = txc.crosscoder_loss(tparams, tacts, k=k, sparsity_weight=SW)
        for key in ("reconstruction_loss", "sparsity_loss"):
            _close(taux[key], jaux[key], 1e-5, key)
    for got, want in pairs:
        _close(got, want, 1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tl, jl, 1e-5, "loss")
    assert float(taux["l0"]) == float(jaux["l0"])
    np.testing.assert_array_equal(taux["active"].numpy(), np.asarray(jaux["active"]))


def _jax_trainer(family, model, cfg, run_dir, every):
    if family == "relu_sae":
        return JSAETrainer(model, cfg, run_dir=run_dir, resample_dead_every=every)
    cls = jct.TranscoderTrainer if family.endswith("transcoder") else jct.CrosscoderTrainer
    return cls(model, cfg, run_dir=run_dir, resample_dead_every=every)


def _port_trainer(family, model, cfg, run_dir, every):
    if family == "relu_sae":
        return SAETrainer(model, cfg, run_dir=run_dir, resample_dead_every=every)
    cls = tct.TranscoderTrainer if family.endswith("transcoder") else tct.CrosscoderTrainer
    return cls(model, cfg, run_dir=run_dir, resample_dead_every=every)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("family", FAMILIES)
def test_trajectory_matches_jax(family, amp, tmp_path, monkeypatch):
    params = _params(family, 3)
    data = _data(family, 4)
    perms = [np.random.default_rng(5 + e).permutation(N) for e in range(EPOCHS)]
    jdata, tdata = _both(data)
    kw = dict(batch_size=B, learning_rate=1e-3, epochs=EPOCHS, warmup_steps=2, use_amp=amp, seed=3)
    # the transcoders resample once (dead after 2 steps, at step 6)
    threshold, every = (2, 6) if family.endswith("transcoder") else (10_000, 5000)
    jm, tm = _models(family, params, threshold)
    jt = _jax_trainer(family, jm, JTrainingConfig(**kw), tmp_path / "j", every)
    tt = _port_trainer(family, tm, TrainingConfig(**kw), tmp_path / "t", every)
    total = EPOCHS * (N // B + 1)
    for t in (jt, tt):
        t.setup_scheduler(total)
    if family.endswith("transcoder"):
        jt.set_resample_dataset(data)
        tt.set_resample_dataset(data)
    if amp:  # the JAX trainers take their windowed Pallas kernels, in interpret mode
        monkeypatch.setattr(pallas_sae, "fused_coder_supported", lambda *a, **k: True)
        monkeypatch.setenv("WST_INDEXED_EPOCH", "1")
    with pltpu.force_tpu_interpret_mode():
        jm_ = [m for p in perms for m in jt.train_epoch_fused(jdata, perm=p)]
    tm_ = [m for p in perms for m in tt.train_epoch_fused(tdata, perm=p)]
    assert len(tm_) == len(jm_) == total
    assert tt.num_resampled_total == jt.num_resampled_total
    if family.endswith("transcoder"):
        assert tt.num_resampled_total > 0
    rtol = 1e-3 if amp else 2e-4
    for key in ("loss", "reconstruction_loss", "sparsity_loss"):
        np.testing.assert_allclose([getattr(m, key) for m in tm_], [getattr(m, key) for m in jm_],
                                   rtol=rtol, atol=1e-7, err_msg=key)
    assert [m.l0 for m in tm_] == pytest.approx([m.l0 for m in jm_], rel=2e-2 if amp else 0)
    if family.startswith("relu"):
        assert all(m.sparsity_loss > 0 for m in tm_)
    if not amp:
        for k in params:
            np.testing.assert_allclose(tt.model.params[k].detach().numpy(),
                                       np.asarray(jt.model.params[k]), atol=2e-4, err_msg=k)
    if family.endswith("crosscoder"):  # flat renorm after every step
        np.testing.assert_allclose(txc.decoder_norms(tt.model.params).detach().numpy(), 1.0,
                                   rtol=1e-5)


def test_transcoder_resample_matches_jax():
    params = _params("skip_transcoder", 6)
    x, y = _data("skip_transcoder", 7)
    jm, tm = _models("skip_transcoder", params, threshold=0)
    for m in (jm, tm):
        m.train()
    jm(jnp.asarray(x[:B]), jnp.asarray(y[:B]))
    tm(torch.from_numpy(x[:B]), torch.from_numpy(y[:B]))
    for _ in range(2):  # every feature not fired in the last step is dead
        jm.state = jsae.update_dead_state(jm.state, jnp.zeros(H, bool))
        tm.state = tsae.update_dead_state(tm.state, torch.zeros(H, dtype=torch.bool))
    np.testing.assert_array_equal(tm.get_dead_features().numpy(),
                                  np.asarray(jm.get_dead_features()))
    nj = jm.resample_dead_features(x[B:3 * B], y[B:3 * B], num_resample=40)
    nt = tm.resample_dead_features(torch.from_numpy(x[B:3 * B]), torch.from_numpy(y[B:3 * B]),
                                   num_resample=40)
    assert nt == nj == 40
    for k in params:
        np.testing.assert_allclose(tm.params[k].detach().numpy(), np.asarray(jm.params[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tm.feature_last_activated.numpy(),
                                  np.asarray(jm.state.feature_last_activated))


def test_transcoder_resample_bf16_rows_match_jax():
    """bf16 (mlp_in, mlp_out) rows: the JAX package normalises the drawn
    inputs in numpy, which widens a bf16 array to float64, and the port
    in f32 from the same (exactly widened) values, so the directions agree
    to f32 rounding."""
    params = _params("topk_transcoder", 8)
    x, y = (jnp.asarray(a).astype(jnp.bfloat16) for a in _data("topk_transcoder", 9))
    tx, ty = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (x, y))
    jm, tm = _models("topk_transcoder", params, threshold=0)
    jm(x[:B], y[:B])
    tm(tx[:B], ty[:B])
    for _ in range(2):
        jm.state = jsae.update_dead_state(jm.state, jnp.zeros(H, bool))
        tm.state = tsae.update_dead_state(tm.state, torch.zeros(H, dtype=torch.bool))
    nj = jm.resample_dead_features(x[B:3 * B], y[B:3 * B], num_resample=40)
    nt = tm.resample_dead_features(tx[B:3 * B], ty[B:3 * B], num_resample=40)
    assert nt == nj == 40
    for k in params:
        np.testing.assert_allclose(tm.params[k].detach().numpy(), np.asarray(jm.params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_crosscoder_layer_norms_match_jax():
    params = _params("relu_crosscoder", 8)
    params["w_dec"][:, 1, :] *= np.where(np.arange(H) % 3 == 0, 0.01, 1.0)[:, None]
    jm, tm = _models("relu_crosscoder", params)
    _close(tm.get_feature_layer_norms(), jm.get_feature_layer_norms(), 1e-6)
    for threshold in (0.1, 0.5):
        got = tm.get_cross_layer_features(threshold).numpy()
        np.testing.assert_array_equal(got, np.asarray(jm.get_cross_layer_features(threshold)))
    assert 0 < got.sum() < H
    tm.normalize_decoder_weights()
    jm.normalize_decoder_weights()
    _close(tm.w_dec, jm.params["w_dec"], 1e-6)
    acts = _data("relu_crosscoder", 9)[:B]
    by_layer = {li: acts[:, i] for i, li in enumerate(tm.layer_indices)}
    jo = jm({li: jnp.asarray(v) for li, v in by_layer.items()})
    to = tm({li: torch.from_numpy(v) for li, v in by_layer.items()})
    for li in tm.layer_indices:
        _close(to.per_layer_loss[li], jo.per_layer_loss[li], 1e-5)
        _close(to.reconstructed[li], jo.reconstructed[li], 1e-5)


def test_skip_transcoder_surface_matches_jax():
    params = _params("skip_transcoder", 10)
    x, y = _data("skip_transcoder", 11)
    jm, tm = _models("skip_transcoder", params)
    mean = y.mean(axis=0)
    jm.set_output_bias(mean)
    tm.set_output_bias(torch.from_numpy(mean))
    _close(tm.skip(torch.from_numpy(x)), jm.skip(jnp.asarray(x)), 1e-5)
    assert tm.get_skip_contribution(x, y) == pytest.approx(jm.get_skip_contribution(x, y),
                                                           rel=1e-5, abs=1e-6)
    zero = ttc.init_skip_transcoder(torch.Generator().manual_seed(0), D, D, H)
    assert not zero["w_dec"].any() and not zero["w_skip"].any() and not zero["b_skip"].any()
    z = ttc.SkipTranscoder(D, D, H, k=K, params=zero, device="cpu")
    z.normalize_decoder_weights()  # zero rows stay zero
    assert not z.w_dec.any()
