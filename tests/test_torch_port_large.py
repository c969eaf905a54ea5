"""The port's large-geometry route against the JAX package's, on the CPU.

Past 48 MiB of bf16 W_enc the port takes the blocked top-k encode
(``ops/csrc/blocked_encode.cu``, its plain version here) and sends f32
masks past H = 3072 to kernel C's CTA-per-row form; where its weights
pass the fused loss's budget it also composes the SAE loss around the
blocked encode -- the route the JAX package takes at whisper-large 32x,
where its weights do not fit in VMEM
(``pallas_sae.py:_encode_forward_blocked``).  The widths here are small
ones: D = 128 or 64, H = 4096, k = 32.  The JAX side runs its blocked
Pallas kernel in interpret mode, with the geometry gates patched so that
these widths reach it; the port's gates are patched the same way where a
test holds the blocked encode (``port_blocked``) or the composed loss
(``port_composed``, ``port_coder_composed``), since kernel B, kernel A's
and the coder kernel's wide routes take these widths.

Tolerances: the blocked encode's mask identically and its bf16 latent
bit for bit, its f32 latent at rtol 1e-6 (f32 sums in another order);
top-k masks exactly; the f32 forward at rtol 2e-4;
gradients at rtol 1e-2 (bf16 products summed in another order); the AMP
trainer's loss trajectory at rtol 1e-3 and parameters at atol 2e-4 (the
bars of tests/test_torch_port_trainer.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.models import transcoder as jtc
from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu.ops import topk as jtopk
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models import transcoder as ttc
from whisper_sae_tpu_torch.ops import cuda_coder, cuda_sae
from whisper_sae_tpu_torch.ops.topk import plain_calls, topk_mask_dense
from whisper_sae_tpu_torch.training import coder_trainers
from whisper_sae_tpu_torch.training import trainer as trainer_mod
from whisper_sae_tpu_torch.training.coder_trainers import TranscoderTrainer
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

D, H, K = 128, 4096, 32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_blocked(monkeypatch):
    """Send the JAX package's bf16 SAE and transcoder encodes at these
    widths to the blocked Pallas kernel (in interpret mode), as at
    whisper-large on a TPU: the Pallas route on, the single-block fused
    losses off."""
    monkeypatch.setattr(ps, "supported", lambda *a: True)
    monkeypatch.setattr(ps, "uses_blocked", lambda *a: True)
    monkeypatch.setattr(ps, "fused_loss_supported", lambda *a: False)
    monkeypatch.setattr(ps, "fused_coder_supported", lambda *a, **k: False)
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def port_blocked(monkeypatch):
    """Send the port's top-k encode at these widths to the blocked encode,
    as past 48 MiB of bf16 W_enc (whisper-large 16x and wider): its gate
    on, as ``jax_blocked`` turns the JAX package's on."""
    monkeypatch.setattr(cuda_sae, "uses_blocked", lambda *a: True)


@pytest.fixture
def port_composed(monkeypatch):
    """Send the port's bf16 SAE loss and its trainer's epoch at these
    widths to the composed loss and the sliced epoch, as at whisper-large:
    kernel A's gate off where it is used."""
    monkeypatch.setattr(tsae, "fused_loss_supported", lambda *a: False)
    monkeypatch.setattr(trainer_mod, "fused_loss_supported", lambda *a: False)


@pytest.fixture
def port_coder_composed(monkeypatch):
    """Send the port's bf16 ReLU-SAE and transcoder losses and their
    trainers' epochs at these widths to the composed losses and the sliced
    epoch, as past the coder kernel's budget (whisper-large 8x): the coder
    gate off where it is used."""
    for mod in (tsae, ttc, trainer_mod, coder_trainers):
        monkeypatch.setattr(mod, "coder_supported", lambda *a, **k: False)


def _sae_params(seed: int, d: int = D, h: int = H) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(d)
    w_dec = rng.standard_normal((h, d))
    return {
        "w_enc": rng.uniform(-bound, bound, (d, h)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, h).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": (rng.standard_normal(d) * 0.1).astype(np.float32),
        "b_pre": (rng.standard_normal(d) * 0.1).astype(np.float32),
    }


def _rows(seed: int, n: int, d: int = D) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the blocked encode
# ---------------------------------------------------------------------------


def test_gates():
    assert cuda_sae.fused_loss_supported(384, 3072) and cuda_sae.fused_loss_supported(64, 512)
    assert not cuda_sae.uses_blocked(384, 3072) and not cuda_sae.uses_blocked(64, 512)
    # the top-k encode's blocked branch is the JAX package's: bf16 W_enc past 48 MiB
    for d, h in ((416, 3072), (384, 3104), (100, 512), (128, 4096)):
        assert not cuda_sae.uses_blocked(d, h) and not cuda_sae.row_kernels_hold(d, h)
    assert cuda_sae.uses_blocked(1280, 40960) and cuda_sae.uses_blocked(1280, 20480)
    # kernel A's wide route takes the loss wherever bf16 W_enc + W_dec fit 48 MiB
    for d, h in ((416, 3072), (384, 3104), (128, 4096)):
        assert cuda_sae.fused_loss_supported(d, h)
    for d, h in ((100, 512), (1280, 40960), (1280, 10240)):
        assert not cuda_sae.fused_loss_supported(d, h)
    # the coder kernel takes every geometry whose bf16 weights fit 48 MiB,
    # these widths too (its wide route past H = 3072)
    assert cuda_coder.coder_supported(1536, 1536, 3072)
    assert cuda_coder.coder_supported(64, 64, 4096)
    assert cuda_coder.coder_supported(64, 64, 4096, with_skip=True)
    assert not cuda_coder.coder_supported(1280, 1280, 10240)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [16, 24])
def test_blocked_encode_matches_pallas_interpret(rows, x_dtype, out, port_blocked):
    p, x = _sae_params(rows), _rows(rows + 1, rows)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if x_dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    with pltpu.force_tpu_interpret_mode():
        want = ps._encode_forward_blocked(
            jx, jnp.asarray(p["w_enc"]).astype(jnp.bfloat16), jnp.asarray(p["b_enc"]),
            jnp.asarray(p["b_pre"]), K, 8, jdt)
    want = np.asarray(want.astype(jnp.float32))
    before = plain_calls["fused_topk_encode_blocked"]
    got = cuda_sae.fused_topk_encode(tx, torch.from_numpy(p["w_enc"]), torch.from_numpy(p["b_enc"]),
                                     torch.from_numpy(p["b_pre"]), K, tdt)
    assert plain_calls["fused_topk_encode_blocked"] == before + 1
    assert got.dtype == tdt and got.shape == (rows, H)
    got = got.float().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(axis=1) == K).all()
    if out == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [24, 20])
@pytest.mark.parametrize("d,h", [(128, 4096), (96, 4160)])
def test_blocked_route_matches_plain_and_pallas_interpret(d, h, rows, out):
    """The card's route written out (``topk_encode_route_plain``: chunks of 8
    rows, here 3 full ones or 2 and a ragged 4; the kPre product; the CTA
    select stopping at a count of exactly k) against kernel B's plain
    version, the mask identically, bf16 bit for bit, f32 at rtol 1e-6 (the
    CPU's f32 product of 8 rows sums in another order than that of 20),
    and against the JAX kernel at test_blocked_encode_matches_pallas_interpret's
    bars."""
    p, x = _sae_params(d + rows, d, h), _rows(d + rows + 1, rows, d)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    we_t = cuda_sae._bf16_t(torch.from_numpy(p["w_enc"]))
    args = (torch.from_numpy(x), we_t, torch.from_numpy(p["b_enc"]), torch.from_numpy(p["b_pre"]),
            K, tdt)
    got = cuda_sae.topk_encode_route_plain(*args, 8)
    assert got.dtype == tdt and got.shape == (rows, h)
    plain = cuda_sae.topk_encode_plain(*args)
    assert torch.equal(got > 0, plain > 0)
    if out == "bf16":
        assert torch.equal(got, plain)
    else:
        torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        want = ps._encode_forward_blocked(
            jnp.asarray(x), jnp.asarray(p["w_enc"]).astype(jnp.bfloat16), jnp.asarray(p["b_enc"]),
            jnp.asarray(p["b_pre"]), K, 8, jdt)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(axis=1) == K).all()
    if out == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_blocked_encode_grads_match_jax(jax_blocked):
    p, x = _sae_params(3), _rows(4, 24)
    g = np.random.default_rng(5).standard_normal((24, H)).astype(np.float32)
    names = ("w_enc", "b_enc", "b_pre")

    def jloss(q, xx):
        h = ps.fused_topk_encode(xx, q["w_enc"], q["b_enc"], q["b_pre"], K, 8, jnp.float32)
        return jnp.sum(h * g)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))({n: jnp.asarray(p[n]) for n in names},
                                              jnp.asarray(x))
    tp = {n: torch.tensor(p[n], requires_grad=True) for n in names}
    tx = torch.tensor(x, requires_grad=True)
    (cuda_sae.fused_topk_encode(tx, tp["w_enc"], tp["b_enc"], tp["b_pre"], K, torch.float32)
     * torch.from_numpy(g)).sum().backward()
    for got, want in [(tp[n].grad, jg[n]) for n in names] + [(tx.grad, jgx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("d,h,route,composed", [(128, 4096, "fused_topk_encode_blocked", True),
                                                (64, 512, "fused_sae_loss", False),
                                                (128, 4096, "fused_sae_loss", False)],
                         ids=["blocked", "kernel_a", "kernel_a_wide"])
def test_loss_route_by_geometry(d, h, route, composed, monkeypatch):
    if composed:  # the whisper-large route at a small width: kernel A's gate off, the blocked on
        monkeypatch.setattr(tsae, "fused_loss_supported", lambda *a: False)
        monkeypatch.setattr(cuda_sae, "uses_blocked", lambda *a: True)
    p, x = params_from_jax(_sae_params(6, d, h)), torch.from_numpy(_rows(7, 32, d))
    before = dict(plain_calls)
    loss, aux = tsae.topk_sae_loss(p, x, K, torch.bfloat16)
    moved = {k: v - before.get(k, 0) for k, v in plain_calls.items() if v != before.get(k, 0)}
    assert moved == {route: 1}
    assert torch.isfinite(loss) and float(aux["l0"]) == K


def test_composed_loss_matches_jax(jax_blocked, port_composed):
    p, x = _sae_params(8), _rows(9, 32)
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jsae.topk_sae_loss(q, jnp.asarray(x), K, jnp.bfloat16), has_aux=True)(_jp(p))
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(p).items()}
    tl, taux = tsae.topk_sae_loss(tp, torch.from_numpy(x), K, torch.bfloat16)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(taux["l0"]) == float(jaux["l0"])
    np.testing.assert_array_equal(taux["active"].numpy(), np.asarray(jaux["active"]))
    for k in p:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# kernel C's wide form and the f32 forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [4096, 40960])
def test_topk_mask_dense_wide_exact(h):
    rng = np.random.default_rng(h)
    pre = rng.standard_normal((8, h)).astype(np.float32)
    pre[:3] = np.round(pre[:3] * 2) / 2  # exact ties at the threshold
    before = plain_calls["topk_mask_wide"]
    got = topk_mask_dense(torch.from_numpy(pre), K).numpy()
    assert plain_calls["topk_mask_wide"] == before + 1
    want = np.asarray(jtopk.topk_mask_dense(jnp.asarray(pre), K))
    np.testing.assert_array_equal(got, want)


def test_forward_f32_matches_jax():
    p, x = _sae_params(10, 64), _rows(11, 48, 64)
    j = jsae.TopKSAE(64, H, K, params=_jp(p))
    t = tsae.TopKSAE(64, H, K, params=params_from_jax(p), device="cpu")
    jout, tout = j(x), t(x)
    for got, want in ((tout.hidden, jout.hidden), (tout.reconstructed, jout.reconstructed)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    np.testing.assert_array_equal(tout.hidden.detach().numpy() > 0, np.asarray(jout.hidden) > 0)
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), rtol=2e-4)
    np.testing.assert_array_equal(t.feature_last_activated.numpy(),
                                  np.asarray(j.state.feature_last_activated))


# ---------------------------------------------------------------------------
# the trainer on the sliced epoch around the blocked encode
# ---------------------------------------------------------------------------

TD, TB, TSTEPS = 64, 32, 4  # width, batch, steps an epoch; 2 epochs


def test_trainer_matches_jax(jax_blocked, port_composed, port_blocked, tmp_path):
    p = _sae_params(12, TD)
    data = _rows(13, TSTEPS * TB, TD)
    perms = [np.random.default_rng(14 + e).permutation(len(data)) for e in range(2)]
    kw = dict(batch_size=TB, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=True, seed=3)
    jt = JSAETrainer(jsae.TopKSAE(TD, H, K, params=_jp(p)), JTrainingConfig(**kw),
                     run_dir=tmp_path / "j")
    tt = SAETrainer(tsae.TopKSAE(TD, H, K, params=params_from_jax(p), device="cpu"),
                    TrainingConfig(**kw), run_dir=tmp_path / "t")
    assert not jt._use_indexed_epoch(data) and not tt._use_indexed_epoch()
    for t in (jt, tt):
        t.setup_scheduler(2 * TSTEPS)
    jl = [m.loss for perm in perms for m in jt.train_epoch_fused(jnp.asarray(data), perm=perm)]
    before = dict(plain_calls)
    tl = [m.loss for perm in perms for m in tt.train_epoch_fused(torch.from_numpy(data), perm=perm)]
    assert plain_calls["fused_topk_encode_blocked"] - before.get("fused_topk_encode_blocked", 0) == 8
    assert plain_calls["fused_sae_loss_indexed"] == before.get("fused_sae_loss_indexed", 0)
    assert len(tl) == len(jl) == 2 * TSTEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k in p:
        np.testing.assert_allclose(tt.model.params[k].detach().numpy(), np.asarray(jt.model.params[k]),
                                   atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(tt.model.feature_last_activated.numpy(),
                                  np.asarray(jt.model.state.feature_last_activated))


# ---------------------------------------------------------------------------
# the ReLU SAE and the transcoder composed, as past the coder kernel's budget
# ---------------------------------------------------------------------------


def test_relu_sae_composed_matches_jax(port_coder_composed):
    p = {k: v for k, v in _sae_params(15, 64).items() if k != "b_pre"}
    x = _rows(16, 32, 64)
    jl, jaux = jsae.relu_sae_loss(_jp(p), jnp.asarray(x), 0.01, jnp.bfloat16)
    before = sum(cuda_coder.plain_calls.values())
    tl, taux = tsae.relu_sae_loss(params_from_jax(p), torch.from_numpy(x), 0.01, torch.bfloat16)
    assert sum(cuda_coder.plain_calls.values()) == before  # composed: no kernel's plain version
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for key in ("reconstruction_loss", "sparsity_loss", "l0"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5, err_msg=key)


def _transcoder_params(seed: int, skip: bool) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    d = 64
    w_dec = rng.standard_normal((H, d))
    p = {"w_enc": rng.uniform(-1, 1, (d, H)) / np.sqrt(d), "b_enc": rng.uniform(-1, 1, H) / np.sqrt(d),
         "w_dec": w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True),
         "b_dec": rng.uniform(-1, 1, d) * 0.1}
    if skip:
        p.update(w_skip=rng.uniform(-1, 1, (d, d)) * 0.3 / np.sqrt(d), b_skip=rng.uniform(-1, 1, d) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _pair(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    y = (np.tanh(x @ rng.standard_normal((64, 64)) / 8) + 0.1 * rng.standard_normal((n, 64)))
    return x, y.astype(np.float32)


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "topk"])
def test_transcoder_blocked_route_matches_jax(jax_blocked, port_coder_composed, port_blocked,
                                              skip):
    p = _transcoder_params(17, skip)
    x, y = _pair(18, 32)
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jtc.transcoder_loss(q, jnp.asarray(x), jnp.asarray(y), K, jnp.bfloat16),
        has_aux=True)(_jp(p))
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(p).items()}
    before = plain_calls["fused_topk_encode_blocked"]
    tl, taux = ttc.transcoder_loss(tp, torch.from_numpy(x), torch.from_numpy(y), K, torch.bfloat16)
    assert plain_calls["fused_topk_encode_blocked"] == before + 1
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(taux["l0"]) == float(jaux["l0"])
    np.testing.assert_array_equal(taux["active"].numpy(), np.asarray(jaux["active"]))
    np.testing.assert_allclose(taux["predicted"].detach().numpy(), np.asarray(jaux["predicted"]),
                               rtol=1e-5, atol=1e-5)
    for k in p:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max(), err_msg=k)


def test_transcoder_trainer_takes_sliced_epoch(tmp_path, port_coder_composed, port_blocked):
    p = _transcoder_params(19, True)
    x, y = _pair(20, 3 * TB)
    model = ttc.create_transcoder(64, 64, H, k=K, use_skip=True, params=params_from_jax(p),
                                  device="cpu")
    cfg = TrainingConfig(batch_size=TB, learning_rate=1e-3, epochs=1, warmup_steps=2, use_amp=True)
    trainer = TranscoderTrainer(model, cfg, run_dir=tmp_path)
    assert not trainer._use_indexed_epoch()
    before = (plain_calls["fused_topk_encode_blocked"], sum(cuda_coder.plain_calls.values()))
    metrics = trainer.train_epoch_fused((torch.from_numpy(x), torch.from_numpy(y)), shuffle=False)
    assert len(metrics) == 3 and all(np.isfinite(m.loss) for m in metrics)
    assert plain_calls["fused_topk_encode_blocked"] == before[0] + 3
    assert sum(cuda_coder.plain_calls.values()) == before[1]
