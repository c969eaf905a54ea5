"""The port's SAETrainer against the JAX package's, on the CPU.

Both start from the same parameters and replay the same explicit batch
order through ``train_epoch_fused`` for 28 steps: 4 epochs of 6 fused
steps plus a 16-row remainder step each, with one forced dead-feature
resample at step 20.  Under AMP the JAX trainer runs its windowed
Pallas kernel (``fused_sae_loss_indexed``, interpret mode) and the port
runs kernel A's plain version at a row offset.

Tolerances: f32 loss trajectory at rtol 2e-4 and final parameters at
atol 2e-4 (the bars of tests/test_torch_parity.py:88-97).  AMP at rtol
1e-3: the bf16 products are summed in another order by XLA and by torch,
so a latent can round to the neighbouring bf16 value, and 28 AdamW steps
carry that difference forward (measured ~3e-6).
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models.sae import TopKSAE as JTopKSAE
from whisper_sae_tpu.ops import pallas_sae
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models.sae import TopKSAE
from whisper_sae_tpu_torch.training.trainer import SAETrainer, adamw_update_, init_adamw
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

D, H, K, B = 128, 512, 8, 64
N = 6 * B + 16
EPOCHS, TOTAL, EVERY = 4, 28, 20


def _setup(seed=1):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((N, D)).astype(np.float32)
    perms = [rng.permutation(N) for _ in range(EPOCHS)]
    bound = 1 / np.sqrt(D)
    w_dec = rng.standard_normal((H, D))
    params = {
        "w_enc": rng.uniform(-bound, bound, (D, H)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, H).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": np.zeros(D, np.float32),
        "b_pre": np.zeros(D, np.float32),
    }
    return data, perms, params


def _kw(amp):
    return dict(batch_size=B, learning_rate=1e-3, epochs=EPOCHS, warmup_steps=2, use_amp=amp, seed=3)


def _run_jax(data, perms, params, amp, run_dir, monkeypatch, resample_rows):
    data = jnp.asarray(data)
    model = JTopKSAE(D, H, K, dead_feature_threshold=3,
                     params={k: jnp.asarray(v) for k, v in params.items()})
    trainer = JSAETrainer(model, JTrainingConfig(**_kw(amp)), run_dir=run_dir,
                          resample_dead_every=EVERY)
    trainer.setup_scheduler(TOTAL)
    trainer.set_resample_dataset(resample_rows)
    if amp:  # take the windowed Pallas epoch on the CPU, in interpret mode
        monkeypatch.setattr(pallas_sae, "fused_loss_supported", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        losses = [m.loss for p in perms for m in trainer.train_epoch_fused(data, perm=p)]
    return trainer, np.array(losses)


def _run_port(data, perms, params, amp, run_dir, resample_rows):
    model = TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(params), device="cpu")
    trainer = SAETrainer(model, TrainingConfig(**_kw(amp)), run_dir=run_dir,
                         resample_dead_every=EVERY)
    trainer.setup_scheduler(TOTAL)
    trainer.set_resample_dataset(resample_rows)
    losses = [m.loss for p in perms for m in trainer.train_epoch_fused(data, perm=p)]
    return trainer, np.array(losses)


@pytest.mark.parametrize("amp,rows", [(False, "f32"), (True, "f32"), (True, "bf16")],
                         ids=["f32", "amp", "amp_bf16_rows"])
def test_trajectory_matches_jax(amp, rows, tmp_path, monkeypatch):
    data, perms, params = _setup()
    if rows == "bf16":  # a bf16 cache: rows staged in bf16 in both packages
        jdata = jnp.asarray(data).astype(jnp.bfloat16)
        tdata = torch.from_numpy(data).bfloat16()
        # resample from the same rows in f32 (the JAX package would
        # normalise bf16 draws in bf16, the port in f32)
        data = np.asarray(jdata.astype(jnp.float32))
    else:
        jdata, tdata = data, data
    jt, jl = _run_jax(jdata, perms, params, amp, tmp_path / "jax", monkeypatch, data)
    tt, tl = _run_port(tdata, perms, params, amp, tmp_path / "port", data)
    assert len(tl) == len(jl) == TOTAL
    assert tt.global_step == jt.global_step == TOTAL
    assert tt.num_resampled_total == jt.num_resampled_total > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if amp else 2e-4)
    for k in params:
        np.testing.assert_allclose(tt.model.params[k].detach().numpy(),
                                   np.asarray(jt.model.params[k]), atol=2e-4)
    np.testing.assert_array_equal(tt.model.feature_last_activated.numpy(),
                                  np.asarray(jt.model.state.feature_last_activated))
    jm = {m.step: m for m in jt.metrics_history}
    for m in tt.metrics_history:
        assert m.learning_rate == pytest.approx(jm[m.step].learning_rate, rel=1e-6)
        assert m.l0 == jm[m.step].l0
        assert m.dead_feature_ratio == pytest.approx(jm[m.step].dead_feature_ratio)

    for t in (jt, tt):
        t.save_metrics()
        t.save_final()
    jrows = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    trows = json.loads((tmp_path / "port" / "metrics.json").read_text())
    assert len(trows) == len(jrows) and [set(r) for r in trows] == [set(r) for r in jrows]
    with np.load(tmp_path / "jax" / "sae_final.npz") as zj, np.load(tmp_path / "port" / "sae_final.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
    sd = torch.load(tmp_path / "port" / "sae_final.pt")
    assert set(sd) == set(torch.load(tmp_path / "jax" / "sae_final.pt"))


def test_train_step_matches_jax(tmp_path):
    data, _, params = _setup(2)
    jm = JTopKSAE(D, H, K, params={k: jnp.asarray(v) for k, v in params.items()})
    jt = JSAETrainer(jm, JTrainingConfig(**_kw(False)), run_dir=tmp_path / "j")
    tm = TopKSAE(D, H, K, params=params_from_jax(params), device="cpu")
    tt = SAETrainer(tm, TrainingConfig(**_kw(False)), run_dir=tmp_path / "t")
    for i in range(5):
        batch = data[i * B:(i + 1) * B]
        a, b = jt.train_step(batch), tt.train_step(batch)
        assert b.step == a.step and b.learning_rate == pytest.approx(a.learning_rate)
        np.testing.assert_allclose(b.loss, a.loss, rtol=2e-4)


def test_clip_follows_optax_rule():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((2,), 4.0)}
    from whisper_sae_tpu_torch.training.trainer import clip_by_global_norm

    norm = float(np.sqrt(4 * 9 + 2 * 16))
    out = clip_by_global_norm(g, 1.0)
    torch.testing.assert_close(out["a"], g["a"] / norm, rtol=1e-6, atol=0)
    kept = clip_by_global_norm(g, 100.0)
    assert torch.equal(kept["a"], g["a"]) and torch.equal(kept["b"], g["b"])


def test_adamw_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    grads = [{"w": rng.standard_normal((3, 4)).astype(np.float32)} for _ in range(3)]
    opt = optax.adamw(learning_rate=lambda c: 1e-2 * (c + 1), b1=0.9, b2=0.999, eps=1e-8,
                      weight_decay=0.1)
    jp = {"w": jnp.asarray(p0["w"])}
    js = opt.init(jp)
    tp = {"w": torch.from_numpy(p0["w"].copy())}
    ts = init_adamw(tp)
    for g in grads:
        upd, js = opt.update({"w": jnp.asarray(g["w"])}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = adamw_update_(tp, {"w": torch.from_numpy(g["w"])}, ts, 1e-2 * (ts.count + 1), 0.1)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)
    assert ts.count == 3


def test_checkpoint_resume_continues_identically(tmp_path):
    data, perms, params = _setup(3)

    def fresh(run_dir):
        model = TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(params), device="cpu")
        t = SAETrainer(model, TrainingConfig(**_kw(True)), run_dir=run_dir, resample_dead_every=EVERY)
        t.setup_scheduler(TOTAL)
        t.set_resample_dataset(data)
        return t

    straight = fresh(tmp_path / "a")
    for p in perms:
        straight.train_epoch_fused(data, perm=p)
    first = fresh(tmp_path / "b")
    for p in perms[:2]:
        first.train_epoch_fused(data, perm=p)
    first.save_checkpoint("mid.npz")
    resumed = fresh(tmp_path / "b")
    resumed.load_checkpoint(tmp_path / "b" / "mid.npz")
    assert resumed.global_step == first.global_step and resumed.epoch == 2
    assert len(resumed.metrics_history) == first.global_step
    for p in perms[2:]:
        resumed.train_epoch_fused(data, perm=p)
    for k in params:
        assert torch.equal(resumed.model.params[k], straight.model.params[k])
    assert [m.loss for m in resumed.metrics_history] == [m.loss for m in straight.metrics_history]


@pytest.mark.parametrize("fused", [None, False], ids=["fused_epoch", "per_step"])
def test_train_loop_writes_checkpoints(tmp_path, fused):
    from whisper_sae_tpu_torch.data.loader import ActivationLoader

    data, _, params = _setup(4)
    model = TopKSAE(D, H, K, params=params_from_jax(params), device="cpu")
    cfg = TrainingConfig(**{**_kw(True), "epochs": 2, "checkpoint_every": 1})
    trainer = SAETrainer(model, cfg, run_dir=tmp_path)
    trainer.train(ActivationLoader(data, B, seed=0), fused=fused)
    assert trainer.global_step == 2 * 7 and trainer.epoch == 2
    for name in ("checkpoint_epoch1.npz", "checkpoint_epoch2.npz", "final.npz", "metrics.json"):
        assert (tmp_path / name).exists()
    rows = json.loads((tmp_path / "metrics.json").read_text())
    assert [r["step"] for r in rows] == list(range(1, 15))
