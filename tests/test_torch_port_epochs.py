"""``SAETrainer.train_epochs_fused`` (epochs chained on the device, one
metrics fetch) and ``train()``'s grouping of fused epochs between
checkpoints, in the port against the JAX package's trainer and against
the port's own sequential ``train_epoch_fused`` loop, on the CPU.

- Unshuffled, 3 chained epochs follow the JAX trainer's (f32 and AMP; under
  AMP the JAX trainer runs its windowed Pallas kernel in interpret mode
  and the port kernel A's plain version at a row offset).
- Shuffled, the chained epochs equal the sequential loop bit for bit in
  parameters, AdamW and dead-feature state and metrics, with one fetch
  of metrics instead of one an epoch.
- The fallbacks to the sequential loop (a remainder batch, fewer rows than
  a batch, a resample dataset) are JAX's, and follow its trajectory.
- ``train()`` groups epochs up to each checkpoint boundary as JAX's does:
  the same group sizes, checkpoint files and printed epoch lines.

Tolerances: the bars of ``tests/test_torch_port_trainer.py`` -- loss
trajectories at rtol 2e-4 in f32 and 1e-3 under AMP, final parameters at
atol 2e-4; the port against itself bit for bit.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.data.loader import ActivationLoader as JActivationLoader
from whisper_sae_tpu.models.sae import TopKSAE as JTopKSAE
from whisper_sae_tpu.ops import pallas_sae
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.data.loader import ActivationLoader
from whisper_sae_tpu_torch.models.sae import TopKSAE
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

D, H, K, B = 64, 256, 8, 32
STEPS = 4
EPOCHS, EVERY = 3, 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, D)).astype(np.float32)
    bound = 1 / np.sqrt(D)
    w_dec = rng.standard_normal((H, D))
    params = {
        "w_enc": rng.uniform(-bound, bound, (D, H)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, H).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": np.zeros(D, np.float32),
        "b_pre": np.zeros(D, np.float32),
    }
    return data, params


def _kw(amp: bool, **extra):
    return {**dict(batch_size=B, learning_rate=1e-3, epochs=EPOCHS, warmup_steps=2, use_amp=amp,
                   seed=3), **extra}


def _jax_trainer(params, amp, run_dir, monkeypatch, **kw):
    model = JTopKSAE(D, H, K, dead_feature_threshold=3,
                     params={k: jnp.asarray(v) for k, v in params.items()})
    if amp:  # the windowed Pallas epoch on the CPU, in interpret mode
        monkeypatch.setattr(pallas_sae, "fused_loss_supported", lambda *a: True)
    return JSAETrainer(model, JTrainingConfig(**_kw(amp, **kw)), run_dir=run_dir,
                       resample_dead_every=EVERY)


def _port_trainer(params, amp, run_dir, **kw):
    model = TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(params),
                    device="cpu")
    return SAETrainer(model, TrainingConfig(**_kw(amp, **kw)), run_dir=run_dir,
                      resample_dead_every=EVERY)


def _same_trajectory(tt, jt, tm, jm, amp):
    assert [m.step for m in tm] == [m.step for m in jm]
    assert tt.global_step == jt.global_step and tt.epoch == jt.epoch
    np.testing.assert_allclose([m.loss for m in tm], [m.loss for m in jm],
                               rtol=1e-3 if amp else 2e-4)
    for a, b in zip(tm, jm):
        assert a.learning_rate == pytest.approx(b.learning_rate, rel=1e-6)
        assert a.l0 == b.l0
    for k in tt.model.params:
        np.testing.assert_allclose(tt.model.params[k].detach().numpy(),
                                   np.asarray(jt.model.params[k]), atol=2e-4)
    np.testing.assert_array_equal(tt.model.feature_last_activated.numpy(),
                                  np.asarray(jt.model.state.feature_last_activated))


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_chained_epochs_follow_jax_unshuffled(tmp_path, monkeypatch, amp):
    data, params = _setup(STEPS * B)
    jt = _jax_trainer(params, amp, tmp_path / "jax", monkeypatch)
    tt = _port_trainer(params, amp, tmp_path / "port")
    for t in (jt, tt):
        t.setup_scheduler(EPOCHS * STEPS)
    with pltpu.force_tpu_interpret_mode():
        jm = jt.train_epochs_fused(jnp.asarray(data), EPOCHS, shuffle=False)
    tm = tt.train_epochs_fused(data, EPOCHS, shuffle=False)
    assert len(tm) == len(jm) == EPOCHS * STEPS and tt.epoch == EPOCHS
    _same_trajectory(tt, jt, tm, jm, amp)
    assert tt.metrics_history == tm


def _count_fetches(monkeypatch) -> list:
    """Records each ``Tensor.cpu`` call: the trainer's metric fetches."""
    calls: list = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    return calls


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_chained_epochs_equal_the_sequential_loop(tmp_path, monkeypatch, amp):
    data, params = _setup(STEPS * B, seed=2)
    chained = _port_trainer(params, amp, tmp_path / "a")
    loop = _port_trainer(params, amp, tmp_path / "b")
    for t in (chained, loop):
        t.setup_scheduler(2 * EPOCHS * STEPS)
        t.train_epoch_fused(data)  # an epoch first: the chain starts at epoch 1
    fetches = _count_fetches(monkeypatch)
    cm = chained.train_epochs_fused(data, EPOCHS, seed=9)
    assert fetches == [(EPOCHS, STEPS, 5)]  # the one fetch: every epoch's metric rows
    fetches.clear()
    lm = [m for _ in range(EPOCHS) for m in loop.train_epoch_fused(data, seed=9)]
    assert fetches == [(STEPS, 5)] * EPOCHS
    assert cm == lm and chained.metrics_history == loop.metrics_history
    assert (chained.global_step, chained.epoch) == (loop.global_step, loop.epoch) == (
        (EPOCHS + 1) * STEPS, EPOCHS + 1)
    for k in chained.model.params:
        assert torch.equal(chained.model.params[k], loop.model.params[k]), k
        assert torch.equal(chained.opt_state.mu[k], loop.opt_state.mu[k])
        assert torch.equal(chained.opt_state.nu[k], loop.opt_state.nu[k])
    assert chained.opt_state.count == loop.opt_state.count
    assert torch.equal(chained.model.feature_last_activated, loop.model.feature_last_activated)
    assert torch.equal(chained.model.step_count, loop.model.step_count)


@pytest.mark.parametrize("case", ["remainder", "fewer_rows_than_a_batch", "resample"])
def test_fallbacks_are_jax_s(tmp_path, monkeypatch, case):
    """Where an epoch boundary needs the host, both packages run the
    sequential loop, one ``train_epoch_fused`` an epoch."""
    n = {"remainder": STEPS * B + 16, "fewer_rows_than_a_batch": B - 8,
         "resample": STEPS * B}[case]
    data, params = _setup(n, seed=4)
    jt = _jax_trainer(params, False, tmp_path / "jax", monkeypatch)
    tt = _port_trainer(params, False, tmp_path / "port")
    calls = {"jax": 0, "port": 0}
    for name, t in (("jax", jt), ("port", tt)):
        t.setup_scheduler(EPOCHS * (STEPS + 1))
        if case == "resample":
            t.set_resample_dataset(data)
        real = t.train_epoch_fused

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        t.train_epoch_fused = counted
    jm = jt.train_epochs_fused(jnp.asarray(data), EPOCHS, shuffle=False)
    tm = tt.train_epochs_fused(data, EPOCHS, shuffle=False)
    assert calls == {"jax": EPOCHS, "port": EPOCHS}
    _same_trajectory(tt, jt, tm, jm, False)
    if case == "resample":
        assert tt.num_resampled_total == jt.num_resampled_total > 0


def test_train_groups_epochs_between_checkpoints_as_jax(tmp_path, monkeypatch, capsys):
    """5 epochs, a checkpoint every 2: chained groups of 2, 2 and 1 in both
    packages, the same checkpoint files and one printed line an epoch."""
    data, params = _setup(STEPS * B, seed=5)
    kw = dict(epochs=5, checkpoint_every=2)
    jt = _jax_trainer(params, False, tmp_path / "jax", monkeypatch, **kw)
    tt = _port_trainer(params, False, tmp_path / "port", **kw)
    groups = {"jax": [], "port": []}
    for name, t in (("jax", jt), ("port", tt)):
        real = t.train_epochs_fused

        def grouped(data, epochs, *a, _real=real, _name=name, **kwargs):
            groups[_name].append(epochs)
            return _real(data, epochs, *a, **kwargs)

        t.train_epochs_fused = grouped
    jt.train(JActivationLoader(data, B, shuffle=False))
    jlines = re.findall(r"^Epoch (\d+):", capsys.readouterr().out, re.M)
    tt.train(ActivationLoader(data, B, shuffle=False))
    tlines = re.findall(r"^Epoch (\d+):", capsys.readouterr().out, re.M)
    assert groups == {"jax": [2, 2, 1], "port": [2, 2, 1]}
    assert tlines == jlines == ["1", "2", "3", "4", "5"]
    files = {t: sorted(p.name for p in (tmp_path / t).glob("*.npz")) for t in ("jax", "port")}
    assert files["port"] == files["jax"] == ["checkpoint_epoch2.npz", "checkpoint_epoch4.npz",
                                            "final.npz"]
    _same_trajectory(tt, jt, tt.metrics_history, jt.metrics_history, False)
