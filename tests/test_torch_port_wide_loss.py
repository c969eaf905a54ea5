"""Kernel A at the geometries past its warp form, on the CPU.

The JAX package fuses the AMP training forward in one Pallas kernel
wherever bf16 W_enc + W_dec fit its 48 MiB VMEM budget
(``pallas_sae.py:fused_loss_supported``); the port's kernel A takes the
same geometries, through its warp form at D <= 384 and H <= 3072 and its
wide route (``sae_fused_loss_wide_fwd``: one CTA a row, the decode's
warps over D) past either limit.  On the CPU both routes are kernel A's
plain version, held here against the JAX kernel in interpret mode at a
row wider than a warp's registers (D=128, H=3200) and at a D beyond one
decode pass (D=512, H=512), sliced and at a row offset, f32 and bf16
rows; the port's AMP trainer's windowed epoch against the JAX trainer's
at D=512; and the gates' table at the Whisper widths.

Tolerances (those of tests/test_torch_port_kernels.py and
tests/test_torch_port_trainer.py): the loss at rtol 1e-5, l0 and the
any-active vector exactly, gradients at rtol 1e-2 (bf16 products summed
in another order); the AMP trajectory at rtol 1e-3 and parameters at
atol 2e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models.sae import TopKSAE as JTopKSAE
from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models.sae import TopKSAE
from whisper_sae_tpu_torch.ops import cuda_sae
from whisper_sae_tpu_torch.ops.topk import plain_calls
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

B, BLOCK = 64, 8
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")
# (D, H, k): a row wider than a warp's registers; D beyond one decode pass
GEOMS = [(128, 3200, 32), (512, 512, 8)]
GEOM_IDS = ["wide_row", "wide_d"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed: int, d: int, h: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "w_enc": (rng.standard_normal((d, h)) * 0.2).astype(np.float32),
        "b_enc": (rng.standard_normal(h) * 0.05).astype(np.float32),
        "b_pre": (rng.standard_normal(d) * 0.05).astype(np.float32),
        "w_dec": (rng.standard_normal((h, d)) * 0.2).astype(np.float32),
        "b_dec": (rng.standard_normal(d) * 0.05).astype(np.float32),
    }


def _rows(seed: int, n: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _jax_loss_and_grads(loss_fn, p, h):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (loss, l0, active), vjp = jax.vjp(loss_fn, jp)
    (grads,) = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32),
                    np.zeros(h, jax.dtypes.float0)))
    return float(loss), float(l0), np.asarray(active), {k: np.asarray(v) for k, v in grads.items()}


def _check(loss, l0, active, tp, want):
    jl, jl0, jact, jg = want
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    assert float(l0) == jl0
    np.testing.assert_array_equal(active.numpy(), jact)
    for name in NAMES:
        w = np.asarray(jg[name], np.float32)
        np.testing.assert_allclose(tp[name].grad.numpy(), w, rtol=1e-2,
                                   atol=1e-5 * float(np.max(np.abs(w))), err_msg=name)


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,h,k", GEOMS, ids=GEOM_IDS)
def test_wide_fused_loss_matches_pallas_interpret(d, h, k, x_dtype):
    assert cuda_sae.fused_loss_supported(d, h) and not cuda_sae.row_kernels_hold(d, h)
    p, x = _params(d + h, d, h), _rows(d + h + 1, B, d)
    if x_dtype == "bf16":  # rows staged in bf16 (a bf16 cache)
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if x_dtype == "bf16" else torch.float32)

    def loss_fn(q):
        with pltpu.force_tpu_interpret_mode():
            return ps.fused_sae_loss(xj, q["w_enc"], q["b_enc"], q["b_pre"], q["w_dec"],
                                     q["b_dec"], k, BLOCK)

    want = _jax_loss_and_grads(loss_fn, p, h)
    tp = {n: torch.tensor(v, requires_grad=True) for n, v in p.items()}
    before = plain_calls["fused_sae_loss"]
    loss, l0, active = cuda_sae.fused_sae_loss(xt, *(tp[n] for n in NAMES), k)
    assert plain_calls["fused_sae_loss"] == before + 1
    loss.backward()
    _check(loss.detach(), l0, active, tp, want)


@pytest.mark.parametrize("step", [0, 2])
@pytest.mark.parametrize("d,h,k", GEOMS, ids=GEOM_IDS)
def test_wide_indexed_fused_loss_matches_pallas_interpret(d, h, k, step):
    p, buf = _params(d + h + step, d, h), _rows(d + h + 7, 3 * B, d)

    def loss_fn(q):
        with pltpu.force_tpu_interpret_mode():
            return ps.fused_sae_loss_indexed(
                jnp.asarray(buf), jnp.int32(step), q["w_enc"], q["b_enc"], q["b_pre"],
                q["w_dec"], q["b_dec"], k, BLOCK, B)

    want = _jax_loss_and_grads(loss_fn, p, h)
    tp = {n: torch.tensor(v, requires_grad=True) for n, v in p.items()}
    before = plain_calls["fused_sae_loss_indexed"]
    loss, l0, active = cuda_sae.fused_sae_loss_indexed(
        torch.from_numpy(buf), step, *(tp[n] for n in NAMES), k, B)
    assert plain_calls["fused_sae_loss_indexed"] == before + 1
    loss.backward()
    _check(loss.detach(), l0, active, tp, want)


# ---------------------------------------------------------------------------
# the windowed AMP epoch at D = 512
# ---------------------------------------------------------------------------

TD, TH, TK, TB = 512, 512, 8, 32
TN = 3 * TB + 16  # 3 windowed steps and a 16-row remainder step an epoch


def test_windowed_amp_epoch_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(21)
    data = rng.standard_normal((TN, TD)).astype(np.float32)
    perms = [rng.permutation(TN) for _ in range(2)]
    bound = 1 / np.sqrt(TD)
    w_dec = rng.standard_normal((TH, TD))
    p = {
        "w_enc": rng.uniform(-bound, bound, (TD, TH)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, TH).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": np.zeros(TD, np.float32),
        "b_pre": np.zeros(TD, np.float32),
    }
    kw = dict(batch_size=TB, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=True, seed=3)
    jt = JSAETrainer(JTopKSAE(TD, TH, TK, params={k: jnp.asarray(v) for k, v in p.items()}),
                     JTrainingConfig(**kw), run_dir=tmp_path / "j")
    tt = SAETrainer(TopKSAE(TD, TH, TK, params=params_from_jax(p), device="cpu"),
                    TrainingConfig(**kw), run_dir=tmp_path / "t")
    monkeypatch.setattr(ps, "fused_loss_supported", lambda *a: True)  # the windowed Pallas epoch
    assert jt._use_indexed_epoch(jnp.asarray(data)) and tt._use_indexed_epoch()
    for t in (jt, tt):
        t.setup_scheduler(8)
    with pltpu.force_tpu_interpret_mode():
        jl = [m.loss for perm in perms for m in jt.train_epoch_fused(jnp.asarray(data), perm=perm)]
    before = dict(plain_calls)
    tl = [m.loss for perm in perms for m in tt.train_epoch_fused(torch.from_numpy(data), perm=perm)]
    moved = {k: v - before.get(k, 0) for k, v in plain_calls.items() if v != before.get(k, 0)}
    assert moved == {"fused_sae_loss_indexed": 6, "fused_sae_loss": 2}
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k in p:
        np.testing.assert_allclose(tt.model.params[k].detach().numpy(), np.asarray(jt.model.params[k]),
                                   atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(tt.model.feature_last_activated.numpy(),
                                  np.asarray(jt.model.state.feature_last_activated))


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

# (D, H) of the Whisper widths: kernel A takes those the JAX package fuses
# (bf16 W_enc + W_dec within 48 MiB), and composes whisper-large and tiny
# 128x; the top-k encode takes the blocked encode past 48 MiB of bf16 W_enc
# alone (whisper-large 32x), as the JAX package's uses_blocked
GATE_TABLE = {
    "tiny_8x": (384, 3072, True), "tiny_16x": (384, 6144, True), "tiny_32x": (384, 12288, True),
    "tiny_64x": (384, 24576, True), "base_8x": (512, 4096, True), "base_32x": (512, 16384, True),
    "small_8x": (768, 6144, True), "small_16x": (768, 12288, True),
    "medium_8x": (1024, 8192, True), "large_8x": (1280, 10240, False),
    "large_32x": (1280, 40960, False), "tiny_128x": (384, 49152, False),
}


@pytest.mark.parametrize("name", GATE_TABLE)
def test_kernel_a_gate_table(name):
    d, h, fused = GATE_TABLE[name]
    assert cuda_sae.fused_loss_supported(d, h) is fused
    assert cuda_sae.row_kernels_hold(d, h) is (name == "tiny_8x")
    assert cuda_sae.uses_blocked(d, h) is (name == "large_32x")


def test_kernel_b_keeps_the_blocked_encode_at_base_8x():
    """At (512, 4096) kernel A takes the loss, and the top-k encode (eval,
    resampling) takes kernel B, as the JAX package takes its non-blocked
    encode there (bf16 W_enc 4 MiB): its plain version runs, no launch is
    counted."""
    d, h, k = 512, 4096, 32
    p = params_from_jax(_params(3, d, h))
    x = torch.from_numpy(_rows(4, 16, d))
    enc = cuda_sae.fused_topk_encode
    before = (dict(plain_calls), enc.launches, enc.blocked_launches)
    hid = enc(x, p["w_enc"], p["b_enc"], p["b_pre"], k)
    loss, aux = tsae.topk_sae_loss(p, x, k, torch.bfloat16)
    moved = {n: v - before[0].get(n, 0) for n, v in plain_calls.items() if v != before[0].get(n, 0)}
    assert moved == {"fused_topk_encode": 1, "fused_sae_loss": 1}
    assert (enc.launches, enc.blocked_launches) == before[1:]
    assert hid.shape == (16, h) and int((hid > 0).sum(dim=1).min()) == k
    assert bool(torch.isfinite(loss)) and float(aux["l0"]) == k
