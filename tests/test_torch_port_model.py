"""The port's TopK-SAE model, schedule and checkpoint files against the JAX
package's, on the CPU, from the same parameters (carried across with
``params_from_jax``).

Tolerances: f32 forwards at rtol 1e-5 (same algorithm, f32 sums in
another order); bf16 forwards within bf16 rounding of the latent; the
schedule bit for bit.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu.config import SAEConfig as JSAEConfig
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.training import schedule as jsched
from whisper_sae_tpu.utils import checkpoint as jckpt
from whisper_sae_tpu_torch.config import ExperimentConfig, SAEConfig
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.training import schedule as tsched
from whisper_sae_tpu_torch.utils import checkpoint as tckpt

B, D, H, K = 64, 128, 512, 8


def _np_params(seed: int = 0) -> dict[str, np.ndarray]:
    """The init's distributions (decoder rows of norm 0.1, encoder
    U(+-1/sqrt(D))), drawn with numpy; nonzero biases."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(D)
    w_dec = rng.standard_normal((H, D))
    return {
        "w_enc": rng.uniform(-bound, bound, (D, H)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, H).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": (rng.standard_normal(D) * 0.1).astype(np.float32),
        "b_pre": (rng.standard_normal(D) * 0.1).astype(np.float32),
    }


def _x(seed: int = 1, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_tiny_default_yaml_loads_unchanged():
    cfg = ExperimentConfig.from_yaml("configs/tiny_default.yaml")
    assert (cfg.whisper.hidden_dim, cfg.sae.k, cfg.sae.expansion_factor) == (384, 32, 8)
    assert cfg.training.batch_size == 128 and cfg.training.use_amp
    from whisper_sae_tpu.config import ExperimentConfig as JExperimentConfig

    assert cfg.model_dump(mode="json") == JExperimentConfig.from_yaml(
        "configs/tiny_default.yaml").model_dump(mode="json")


def test_apply_f32_matches_jax():
    p, x = _np_params(), _x()
    jout, jact = jsae.topk_sae_apply(_jp(p), jnp.asarray(x), K, jnp.float32)
    tout, tact = tsae.topk_sae_apply(tckpt.params_from_jax(p), torch.from_numpy(x), K)
    np.testing.assert_array_equal(tout.hidden.numpy() > 0, np.asarray(jout.hidden) > 0)
    np.testing.assert_allclose(tout.hidden.numpy(), np.asarray(jout.hidden), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout.reconstructed.numpy(), np.asarray(jout.reconstructed),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), rtol=1e-5)
    assert float(tout.l0) == float(jout.l0)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))


def test_apply_bf16_matches_jax():
    p, x = _np_params(2), _x(3)
    jout, jact = jsae.topk_sae_apply(_jp(p), jnp.asarray(x), K, jnp.bfloat16)
    tout, tact = tsae.topk_sae_apply(tckpt.params_from_jax(p), torch.from_numpy(x), K,
                                     torch.bfloat16)
    want = np.asarray(jout.hidden, np.float32)
    got = tout.hidden.float().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), rtol=1e-5)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_and_grads_match_jax(dtype):
    p, x = _np_params(4), _x(5)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jsae.topk_sae_loss(q, jnp.asarray(x), K, jdt), has_aux=True)(_jp(p))
    tp = {k: v.requires_grad_(True) for k, v in tckpt.params_from_jax(p).items()}
    tl, taux = tsae.topk_sae_loss(tp, torch.from_numpy(x), K, tdt)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(taux["l0"]) == float(jaux["l0"])
    np.testing.assert_array_equal(taux["active"].numpy(), np.asarray(jaux["active"]))
    # bf16: the JAX composed path autodiffs its bf16 dots, the port runs
    # the fused kernel's VJP (f32 sums of bf16 products): bf16 tolerance
    rtol, atol = (1e-4, 1e-6) if dtype == "f32" else (1e-2, 1e-2)
    for k in p:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=rtol,
                                   atol=atol * np.abs(want).max())


def test_normalize_decoder_unit_rows():
    p = tckpt.params_from_jax(_np_params())
    p["w_dec"] = p["w_dec"] * 7.0
    out = tsae.normalize_decoder(p)
    np.testing.assert_allclose(torch.linalg.vector_norm(out["w_dec"], dim=1).numpy(), 1.0, rtol=1e-6)
    want = jsae.normalize_decoder(_jp({k: v.numpy() for k, v in p.items()}))["w_dec"]
    np.testing.assert_allclose(out["w_dec"].numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _facades(p, threshold=2):
    j = jsae.TopKSAE(D, H, K, dead_feature_threshold=threshold, params=_jp(p))
    t = tsae.TopKSAE(D, H, K, dead_feature_threshold=threshold,
                     params=tckpt.params_from_jax(p), device="cpu")
    return j, t


def test_facade_dead_state_matches_jax():
    j, t = _facades(_np_params(6))
    for i in range(5):
        x = _x(10 + i, n=16)
        jout, tout = j(x), t(x)
        np.testing.assert_allclose(tout.loss.item(), float(jout.loss), rtol=1e-5)
    np.testing.assert_array_equal(t.feature_last_activated.numpy(),
                                  np.asarray(j.state.feature_last_activated))
    assert int(t.step_count) == j.step_count == 5
    np.testing.assert_array_equal(t.get_dead_features().numpy(), np.asarray(j.get_dead_features()))
    assert t.get_dead_feature_ratio() == pytest.approx(j.get_dead_feature_ratio())
    t.eval()
    t(_x(20))
    assert int(t.step_count) == 5  # eval mode leaves the counters alone


def test_facade_normalize_and_decode():
    j, t = _facades(_np_params(7))
    t.normalize_decoder_weights()
    j.normalize_decoder_weights()
    np.testing.assert_allclose(torch.linalg.vector_norm(t.w_dec, dim=1).detach().numpy(), 1.0,
                               rtol=1e-6)
    x = _x(8)
    h = t.encode(x).detach()
    np.testing.assert_allclose(h.numpy(), np.asarray(j.encode(x)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.decode(h).detach().numpy(),
                               np.asarray(j.decode(jnp.asarray(h.numpy()))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_resample", [None, 3])
def test_resample_matches_jax(num_resample):
    j, t = _facades(_np_params(9), threshold=1)
    for i in range(4):
        x = _x(30 + i, n=8)
        j(x)
        t(x)
    inputs = _x(40, n=128)
    nj = j.resample_dead_features(inputs, num_resample)
    nt = t.resample_dead_features(inputs, num_resample)
    assert nt == nj > 0
    for k in tsae.PARAM_NAMES:
        np.testing.assert_allclose(t.params[k].detach().numpy(), np.asarray(j.params[k]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t.feature_last_activated.numpy(),
                                  np.asarray(j.state.feature_last_activated))


def test_init_distributions():
    p = tsae.init_topk_sae(torch.Generator().manual_seed(0), D, H)
    np.testing.assert_allclose(torch.linalg.vector_norm(p["w_dec"], dim=1).numpy(), 0.1, rtol=1e-5)
    bound = 1 / np.sqrt(D)
    assert float(p["w_enc"].abs().max()) <= bound and float(p["w_enc"].abs().max()) > 0.9 * bound
    assert float(p["b_enc"].abs().max()) <= bound
    assert not p["b_dec"].any() and not p["b_pre"].any()
    j = jsae.init_topk_sae(jax.random.PRNGKey(0), D, H)
    for k in j:
        assert tuple(p[k].shape) == j[k].shape


def test_create_sae():
    sae = tsae.create_sae(SAEConfig(k=K, expansion_factor=4), input_dim=D, device="cpu")
    assert (sae.input_dim, sae.hidden_dim, sae.k) == (D, 4 * D, K)
    for activation in ("relu", "gelu"):  # any activation but topk builds a ReLU SAE
        relu = tsae.create_sae(SAEConfig(activation=activation, expansion_factor=4), input_dim=D,
                               device="cpu")
        assert isinstance(relu, tsae.ReLUSAE)
        assert (relu.input_dim, relu.hidden_dim, relu.sparsity_weight) == (D, 4 * D, 0.01)


@pytest.mark.parametrize("total,warmup", [(100, 10), (57, 1000), (40, 0), (1, 0)])
def test_schedule_bit_identical(total, warmup):
    steps = np.arange(total + 1)
    want = np.asarray(jsched.warmup_cosine_schedule(1e-4, total, warmup)(steps))
    got = tsched.warmup_cosine_schedule(1e-4, total, warmup)(steps)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for s in (0, total // 2, total):
        assert tsched.warmup_cosine_schedule(1e-4, total, warmup)(s) == want[s]
    assert tsched.constant_schedule(3e-4)(5) == jsched.constant_schedule(3e-4)(5)


def test_checkpoint_files_cross_read(tmp_path):
    p = _np_params(11)
    tparams = tckpt.params_from_jax(p)
    tckpt.save_pytree(tmp_path / "t.npz", {"params": tparams}, meta={"global_step": 3})
    jtree, jmeta = jckpt.load_pytree(tmp_path / "t.npz", {"params": _jp(p)})
    assert jmeta == {"global_step": 3}
    for k in p:
        np.testing.assert_array_equal(np.asarray(jtree["params"][k]), p[k])
    jckpt.save_pytree(tmp_path / "j.npz", _jp(p))
    loaded = tckpt.load_jax_params(tmp_path / "j.npz")
    for k in p:
        np.testing.assert_array_equal(loaded[k].numpy(), p[k])
    np.testing.assert_array_equal(tckpt.params_to_jax(loaded)["w_enc"], p["w_enc"])


def test_torch_export_matches_jax():
    p = _np_params(12)
    want = jckpt.export_torch_state_dict(_jp(p))
    got = tckpt.export_torch_state_dict(tckpt.params_from_jax(p))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k])
    back = jckpt.import_torch_state_dict(got)
    for k in p:
        np.testing.assert_array_equal(np.asarray(back[k]), p[k])


def test_load_trained_sae_from_jax_run(tmp_path):
    p = _np_params(13)
    jckpt.save_pytree(tmp_path / "sae_final.npz", _jp(p))
    cfg = JSAEConfig(k=K, expansion_factor=4)
    (tmp_path / "training_config.json").write_text(json.dumps({"sae": cfg.model_dump()}))
    sae = tsae.load_trained_sae(tmp_path, device="cpu")
    assert sae.hidden_dim == H and sae.k == K
    for k in p:
        np.testing.assert_array_equal(sae.params[k].detach().numpy(), p[k])
