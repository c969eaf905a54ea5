"""The coder families on the port's meshes against the JAX package's, on
the CPU: the TopK and Skip transcoders, the TopK and ReLU crosscoders
and the ReLU SAE (each with its dp x tp family, ``parallel/tp_step.py``),
on meshes of 4 gloo ranks -- ``(4, 1)``, ``(2, 2)``, ``(1, 4)`` -- each against the JAX
trainer on a mesh of the same shape (``jax.devices()[:4]``) and on one
device, from the same numpy-seeded parameters and batch orders.

Each run takes two steps and a fused epoch with a remainder.  Bars: f32
losses at rtol 2e-4, parameters at atol 2e-4, dead-feature counters
equal; AMP (the Skip transcoder) losses at rtol 1e-3; replicated leaves
(b_dec, w_skip, b_skip) bit for bit across ranks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models.crosscoder import CrossLayerCrosscoder as JCrossLayerCrosscoder
from whisper_sae_tpu.models.crosscoder import TopKCrossLayerCrosscoder as JTopKCrosscoder
from whisper_sae_tpu.models.sae import ReLUSAE as JReLUSAE
from whisper_sae_tpu.models.transcoder import SkipTranscoder as JSkipTranscoder
from whisper_sae_tpu.models.transcoder import TopKTranscoder as JTopKTranscoder
from whisper_sae_tpu.parallel.mesh import make_mesh as jmake_mesh
from whisper_sae_tpu.training.coder_trainers import CrosscoderTrainer as JCrosscoderTrainer
from whisper_sae_tpu.training.coder_trainers import TranscoderTrainer as JTranscoderTrainer
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer

DIN, DOUT, HT, K, B = 16, 24, 128, 4, 64
DX, LX, SX = 16, 3, 128
N = 2 * B + 16
SHAPES = [(4, 1), (2, 2), (1, 4)]
RUNS = [("transcoder", False), ("skip_transcoder", False), ("skip_transcoder", True),
        ("crosscoder", False), ("relu_crosscoder", False), ("relu_sae", False)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _setup(family: str, seed: int = 5):
    """(params in the JAX layout, dims, data, order)."""
    rng = np.random.default_rng(seed)
    if family in ("transcoder", "skip_transcoder"):
        p = {"w_enc": _u(rng, (DIN, HT), DIN ** -0.5), "b_enc": _u(rng, HT, DIN ** -0.5),
             "w_dec": _u(rng, (HT, DOUT), HT ** -0.5), "b_dec": _u(rng, DOUT, 0.1)}
        if family == "skip_transcoder":
            p.update(w_skip=_u(rng, (DIN, DOUT), 0.1), b_skip=_u(rng, DOUT, 0.1))
        x = rng.standard_normal((N, DIN)).astype(np.float32)
        y = (x @ rng.standard_normal((DIN, DOUT)).astype(np.float32) * 0.3).astype(np.float32)
        return p, dict(d=DIN, dout=DOUT, h=HT, k=K), (x, y), rng.permutation(N)
    if family in ("crosscoder", "relu_crosscoder"):
        w_dec = _u(rng, (SX, LX, DX), (SX + LX * DX) ** -0.5)
        p = {"w_enc": np.ascontiguousarray(w_dec.transpose(1, 2, 0)) * 0.9,
             "b_enc": _u(rng, SX, 0.05), "w_dec": w_dec, "b_dec": _u(rng, (LX, DX), 0.05)}
        data = rng.standard_normal((N, LX, DX)).astype(np.float32)
        return p, dict(d=DX, layers=LX, h=SX, k=K), data, rng.permutation(N)
    p = {"w_enc": _u(rng, (DIN, HT), DIN ** -0.5), "b_enc": _u(rng, HT, DIN ** -0.5),
         "w_dec": _u(rng, (HT, DIN), HT ** -0.5), "b_dec": _u(rng, DIN, HT ** -0.5)}
    return p, dict(d=DIN, h=HT), rng.standard_normal((N, DIN)).astype(np.float32), rng.permutation(N)


def _cfg(amp: bool) -> dict:
    return dict(batch_size=B, learning_rate=1e-3, epochs=1, warmup_steps=1, use_amp=amp, seed=3)


def _first(data, rows):
    return tuple(a[rows] for a in data) if isinstance(data, tuple) else data[rows]


def _ops(data, perm):
    return [("step", _first(data, slice(0, B))), ("step", _first(data, slice(B, 2 * B))),
            ("fused", data, perm)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_coders")
    runs = []
    for family, amp in RUNS:
        params, dims, data, perm = _setup(family)
        runs.append(dict(family=family, params=params, dims=dims, config=_cfg(amp),
                         total_steps=8, ops=_ops(data, perm)))
    groups = [(4, "train", root / f"{s[0]}x{s[1]}", dict(shape=s, runs=runs)) for s in SHAPES]
    return dict(zip(SHAPES, ranks.spawn_groups(groups)))


_SINGLE: dict = {}


def _jax_run(family, amp, mesh, tmp_path):
    if mesh is None and (family, amp) in _SINGLE:
        return _SINGLE[(family, amp)]
    params, dims, data, perm = _setup(family)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    if family in ("transcoder", "skip_transcoder"):
        cls = JSkipTranscoder if family == "skip_transcoder" else JTopKTranscoder
        model, trainer_cls = cls(DIN, DOUT, HT, k=K, dead_feature_threshold=3, params=p), \
            JTranscoderTrainer
    elif family == "crosscoder":
        model, trainer_cls = JTopKCrosscoder(DX, LX, SX, k=K, dead_feature_threshold=3,
                                             params=p), JCrosscoderTrainer
    elif family == "relu_crosscoder":
        model, trainer_cls = JCrossLayerCrosscoder(DX, LX, SX, dead_feature_threshold=3,
                                                   params=p), JCrosscoderTrainer
    else:
        model, trainer_cls = JReLUSAE(DIN, HT, params=p), JSAETrainer
    t = trainer_cls(model, JTrainingConfig(**_cfg(amp)), run_dir=tmp_path, mesh=mesh)
    t.setup_scheduler(8)
    metrics = []
    for op in _ops(data, perm):
        if op[0] == "step":
            metrics.append(t.train_step(op[1]))
        else:
            metrics.extend(t.train_epoch_fused(op[1], perm=op[2]))
    out = (t, metrics)
    if mesh is None:
        _SINGLE[(family, amp)] = out
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("run", range(len(RUNS)), ids=[f"{f}{'_amp' if a else ''}" for f, a in RUNS])
def test_coder_mesh_run_matches_jax(port, run, shape, tmp_path):
    family, amp = RUNS[run]
    results = [r[run] for r in port[shape]]
    got = results[0]
    for r in results[1:]:  # what every rank holds whole is the same bits
        assert r["replicated"] == got["replicated"]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    tp = shape[1] > 1
    assert got["tp"] == tp
    if tp:
        repl = {"b_dec"} | ({"w_skip", "b_skip"} if family == "skip_transcoder" else set())
        assert set(got["replicated"]) == repl
        block = SX // shape[1] if "crosscoder" in family else HT // shape[1]
        assert got["local_shapes"]["b_enc"] == (block,)
    rtol = 1e-3 if amp else 2e-4
    for mesh in (jmake_mesh(*shape, devices=jax.devices()[:4]), None):
        jt, jm = _jax_run(family, amp, mesh, tmp_path / str(mesh is None))
        # the JAX package places the ReLU SAE by its shape rules under
        # GSPMD, without a dp x tp step of its own
        assert mesh is None or jt._is_tp() == (tp and family != "relu_sae")
        assert len(got["losses"]) == len(jm) == 5
        np.testing.assert_allclose(got["losses"], [m.loss for m in jm], rtol=rtol)
        np.testing.assert_allclose(got["sparsity"], [m.sparsity_loss for m in jm], rtol=rtol,
                                   atol=1e-7)
        if amp:
            continue
        np.testing.assert_allclose(got["l0"], [m.l0 for m in jm], atol=1e-2)
        for k, v in jt.model.params.items():
            np.testing.assert_allclose(got["params"][k], np.asarray(v), atol=2e-4, err_msg=k)
        if family != "relu_sae":
            np.testing.assert_array_equal(got["last_activated"],
                                          np.asarray(jt.model.state.feature_last_activated))
