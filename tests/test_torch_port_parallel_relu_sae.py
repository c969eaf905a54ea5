"""The ReLU SAE on the port's dp x tp meshes against the JAX package's, on
the CPU: ``parallel/tp_step.py:relu_sae_family`` (w_enc split on its
feature dim, b_enc and w_dec on theirs, b_dec replicated; the recon
all-reduced over ``model``; the L1 term split per feature block) through
the trainer's public API on meshes of 4 gloo ranks -- ``(2, 2)`` and
``(1, 4)`` -- each against the JAX ``SAETrainer`` with a ``ReLUSAE``
(placed by its shape rules under GSPMD) on a mesh of the same shape built
from ``jax.devices()[:4]``, and on one device, from the same numpy-seeded
parameters and batch orders.

Each run: two steps, a fused epoch with a remainder, a step whose rows do
not split over ``data``, a checkpoint; an AMP run; a run resumed from a
single-device checkpoint.  Bars: f32 losses at rtol 2e-4 and parameters
at atol 2e-4; AMP losses at rtol 1e-3; b_dec bit for bit across ranks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models.sae import ReLUSAE as JReLUSAE
from whisper_sae_tpu.parallel.mesh import make_mesh as jmake_mesh
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.training.trainer import SAETrainer

D, H, B, SPARSITY = 32, 256, 64, 0.1
N = 4 * B + 16  # four fused steps and a 16-row remainder
SHAPES = [(2, 2), (1, 4)]
SINGLE_CKPT_STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=11) -> dict:
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(D)
    w_dec = rng.standard_normal((H, D))
    return {
        "w_enc": rng.uniform(-bound, bound, (D, H)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, H).astype(np.float32),
        "w_dec": (w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": (0.05 * rng.standard_normal(D)).astype(np.float32),
    }


def _data(seed=12):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((8, D)).astype(np.float32)
    data = (rng.standard_normal((N, 8)).astype(np.float32) @ mix
            + 0.1 * rng.standard_normal((N, D)).astype(np.float32))
    return data.astype(np.float32), rng.permutation(N)


def _cfg(amp: bool) -> dict:
    return dict(batch_size=B, learning_rate=2e-3, epochs=1, warmup_steps=2, use_amp=amp, seed=3)


def _ops(data, perm):
    """Steps 1-2, a fused epoch (3-6, the remainder 7), a 63-row step that
    does not split over data (8), then a checkpoint."""
    return [("step", data[:B]), ("step", data[B:2 * B]), ("fused", data, perm),
            ("step", data[:63]), ("save", "mesh.npz")]


def _single_model(params):
    from whisper_sae_tpu_torch.models.sae import ReLUSAE
    from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

    return ReLUSAE(D, H, sparsity_weight=SPARSITY, params=params_from_jax(params), device="cpu")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_relu_sae")
    params = _params()
    data, perm = _data()
    single_path = root / "single" / "single.npz"
    t = SAETrainer(_single_model(params), TrainingConfig(**_cfg(False)), run_dir=single_path.parent)
    t.setup_scheduler(12)
    for i in range(SINGLE_CKPT_STEPS):
        t.train_step(data[i * B:(i + 1) * B])
    t.save_checkpoint(single_path.name)
    base = dict(family="relu_sae", params=params, dims=dict(d=D, h=H, sparsity_weight=SPARSITY),
                total_steps=12)
    runs = [
        dict(base, config=_cfg(False), ops=_ops(data, perm)),
        dict(base, config=_cfg(True), ops=[("step", data[:B]), ("fused", data, perm)]),
        dict(base, config=_cfg(False), ops=[("load", str(single_path)), ("step", data[2 * B:3 * B])]),
    ]
    groups = [(4, "train", root / f"{s[0]}x{s[1]}", dict(shape=s, runs=runs)) for s in SHAPES]
    out = dict(zip(SHAPES, ranks.spawn_groups(groups)))
    out["data"] = (params, data, perm)
    out["single"] = single_path
    return out


_SINGLE: dict = {}


def _jax_run(mesh, amp: bool, ops, tmp_path):
    """The JAX trainer with a ReLU SAE on ``mesh`` (None: one device, run
    once per set of ops) through the same ops but the checkpoint."""
    key = (amp, len(ops))
    if mesh is None and key in _SINGLE:
        return _SINGLE[key]
    params = _params()
    model = JReLUSAE(D, H, sparsity_weight=SPARSITY,
                     params={k: jnp.asarray(v) for k, v in params.items()})
    t = JSAETrainer(model, JTrainingConfig(**_cfg(amp)), run_dir=tmp_path, mesh=mesh)
    t.setup_scheduler(12)
    metrics = []
    for op in ops:
        if op[0] == "step":
            metrics.append(t.train_step(op[1]))
        elif op[0] == "fused":
            metrics.extend(t.train_epoch_fused(op[1], perm=op[2]))
    out = (t, metrics)
    if mesh is None:
        _SINGLE[key] = out
    return out


def _jmesh(shape):
    return jmake_mesh(*shape, devices=jax.devices()[:4])


def _check_ranks_agree(results):
    for r in results[1:]:
        assert r["replicated"] == results[0]["replicated"]
        for k, v in results[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_relu_sae_holds_its_feature_block(port, shape):
    """Each rank holds H / n_model of w_enc, b_enc, w_dec and of their
    AdamW moments; b_dec is whole and the same bits on every rank."""
    m = shape[1]
    for run in (0, 1):  # f32 and AMP
        results = [r[run] for r in port[shape]]
        _check_ranks_agree(results)
        for r in results:
            assert r["tp"]
            assert r["local_shapes"] == {"w_enc": (D, H // m), "b_enc": (H // m,),
                                         "w_dec": (H // m, D), "b_dec": (D,)}
            assert r["moment_shapes"] == {k: (v, v) for k, v in r["local_shapes"].items()}
            assert set(r["replicated"]) == {"b_dec"}
            assert r["params"]["w_enc"].shape == (D, H)  # gathered whole


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_relu_sae_mesh_run_matches_jax(port, shape, tmp_path):
    """f32: steps, a fused epoch with a remainder and a step that does not
    split over data, against JAX's GSPMD run of the same shape and one
    device."""
    _, data, perm = port["data"]
    got = port[shape][0][0]
    ops = _ops(data, perm)[:-1]
    for mesh in (_jmesh(shape), None):
        jt, jm = _jax_run(mesh, False, ops, tmp_path / str(mesh is None))
        assert len(got["losses"]) == len(jm) == got["global_step"] == jt.global_step == 8
        np.testing.assert_allclose(got["losses"], [m.loss for m in jm], rtol=2e-4)
        np.testing.assert_allclose(got["sparsity"], [m.sparsity_loss for m in jm], rtol=2e-4)
        np.testing.assert_allclose(got["l0"], [m.l0 for m in jm], atol=1e-2)
        np.testing.assert_allclose(got["dead"], [m.dead_feature_ratio for m in jm], atol=1e-6)
        for k, v in jt.model.params.items():
            np.testing.assert_allclose(got["params"][k], np.asarray(v), atol=2e-4, err_msg=k)
        np.testing.assert_allclose(np.linalg.norm(got["params"]["w_dec"], axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_relu_sae_mesh_amp_matches_jax(port, shape, tmp_path):
    _, data, perm = port["data"]
    got = port[shape][0][1]
    ops = [("step", data[:B]), ("fused", data, perm)]
    for mesh in (_jmesh(shape), None):
        _, jm = _jax_run(mesh, True, ops, tmp_path / str(mesh is None))
        np.testing.assert_allclose(got["losses"], [m.loss for m in jm], rtol=1e-3)
        np.testing.assert_allclose(got["sparsity"], [m.sparsity_loss for m in jm], rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_relu_sae_mesh_checkpoint_is_the_single_device_file(port, shape):
    """Rank 0's gathered checkpoint has the single-device file's keys,
    shapes and dtypes and loads into a single-device trainer; a
    single-device checkpoint loads into a mesh run, which then steps as
    one device does."""
    from whisper_sae_tpu_torch.utils.checkpoint import load_pytree

    params, data, _ = port["data"]
    got = port[shape][0][0]
    mesh_tree, meta = load_pytree(f"{got['run_dir']}/mesh.npz")
    single_tree, _ = load_pytree(port["single"])

    def layout(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(layout(v, f"{prefix}{k}/") if isinstance(v, dict) else
                       {prefix + k: (np.shape(v), np.asarray(v).dtype)})
        return out

    assert layout(mesh_tree) == layout(single_tree)
    assert meta["global_step"] == got["global_step"]
    for k, v in got["params"].items():
        np.testing.assert_array_equal(mesh_tree["params"][k], v, err_msg=k)
    t = SAETrainer(_single_model(params), TrainingConfig(**_cfg(False)),
                   run_dir=port["single"].parent.parent / f"load{shape}")
    t.load_checkpoint(f"{got['run_dir']}/mesh.npz")
    assert t.global_step == got["global_step"]
    for k, v in t.model.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), got["params"][k], err_msg=k)
    resumed = port[shape][0][2]
    t2 = SAETrainer(_single_model(params), TrainingConfig(**_cfg(False)),
                    run_dir=port["single"].parent.parent / f"resume{shape}")
    t2.load_checkpoint(port["single"])
    m = t2.train_step(data[2 * B:3 * B])
    assert resumed["global_step"] == t2.global_step == SINGLE_CKPT_STEPS + 1
    np.testing.assert_allclose(resumed["losses"], [m.loss], rtol=2e-4)
    for k, v in t2.model.params.items():
        np.testing.assert_allclose(resumed["params"][k], v.detach().numpy(), atol=2e-4, err_msg=k)
