"""The port's ``parallel/`` against the JAX package's, on the CPU: the mesh,
the shard rules, the sharded top-k, the identity-VJP all-reduce, and the
TopK SAE trained on meshes of 4 ranks -- dp ``(4, 1)``, dp x tp ``(2, 2)``
and ``(1, 4)`` -- through the trainer's public API: steps, fused epochs
with a remainder, the chunked out-of-core epoch, resampling per step and
at an epoch boundary, and the gathered checkpoint.

The port's ranks are gloo processes (``tests/torch_parallel_ranks.py``,
``file://`` rendezvous, one thread each), one group per mesh shape; the
JAX side runs the same scenario on a mesh of the same shape built from
``jax.devices()[:4]`` of the virtual CPU mesh (``tests/conftest.py``), and
on one device.  Every side starts from the same numpy-seeded parameters
and replays the same batch orders (the order inside an out-of-core chunk
is pinned to a numpy permutation on both sides, as
``tests/test_torch_port_out_of_core.py`` pins it).

Bars: f32 losses at rtol 2e-4 and parameters at atol 2e-4 (the bars of
``tests/test_torch_port_trainer.py``); AMP losses at rtol 1e-3 (bf16
products summed in other orders); the sharded selection bit for bit; the
dead-feature counters equal; replicated leaves bit for bit across ranks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parallel_ranks as ranks
from whisper_sae_tpu.config import MeshConfig as JMeshConfig
from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models.sae import TopKSAE as JTopKSAE
from whisper_sae_tpu.ops import pallas_sae
from whisper_sae_tpu.ops.topk import topk_mask_dense as jtopk_mask_dense
from whisper_sae_tpu.parallel import mesh as jmesh_mod
from whisper_sae_tpu.parallel.sharding import leaf_pspec as jleaf_pspec
from whisper_sae_tpu.parallel.sharding import place_tree as jplace_tree
from whisper_sae_tpu.parallel.tp_step import psum_identity_vjp as jpsum_identity_vjp
from whisper_sae_tpu.parallel.tp_topk import topk_mask_sharded as jtopk_mask_sharded
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import MeshConfig
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.parallel import sharding
from whisper_sae_tpu_torch.training.trainer import SAETrainer

D, H, K, B = 32, 256, 8, 64
N = 4 * B + 16  # four fused steps and a 16-row remainder
EVERY = 4  # resampling: at the first epoch's boundary (step 6 crosses 4) and at step 8
SHAPES = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=1) -> dict:
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(D)
    w_dec = rng.standard_normal((H, D))
    return {
        "w_enc": rng.uniform(-bound, bound, (D, H)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, H).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": (0.05 * rng.standard_normal(D)).astype(np.float32),
        "b_pre": (0.05 * rng.standard_normal(D)).astype(np.float32),
    }


def _data(seed=2):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((N, D)).astype(np.float32)
    return data, rng.permutation(N), rng.permutation(N), (rng.standard_normal((2 * B, D)) *
                                                         1.5).astype(np.float32)


def _cfg(amp: bool) -> dict:
    return dict(batch_size=B, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=amp, seed=3)


def _ops(data, p1, p2):
    """Steps 1-2, a fused epoch (3-6, the remainder 7), a 63-row step that
    does not split over data (8; resampling fires), a fused epoch (9-13;
    resampling at its boundary), a step, a chunked out-of-core epoch of
    three chunks (15-19; resampling at a chunk boundary), a checkpoint."""
    return [("step", data[:B]), ("step", data[B:2 * B]), ("fused", data, p1), ("step", data[:63]),
            ("fused", data, p2), ("step", data[2 * B:3 * B]), ("ooc", data, 2 * B),
            ("save", "mesh.npz")]


SINGLE_CKPT_STEPS = 2


def _single_ckpt(path, params, data):
    """A single-device port checkpoint after two steps (the mesh runs load it)."""
    from whisper_sae_tpu_torch.models.sae import TopKSAE
    from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

    t = SAETrainer(TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(params),
                           device="cpu"), TrainingConfig(**_cfg(False)), run_dir=path.parent)
    t.setup_scheduler(20)
    for i in range(SINGLE_CKPT_STEPS):
        t.train_step(data[i * B:(i + 1) * B])
    t.save_checkpoint(path.name)
    return t


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each mesh shape's group: the f32 run (steps, fused epochs with a
    remainder, resampling, the out-of-core epoch, a checkpoint), the AMP
    run, and a run resumed from a single-device checkpoint."""
    root = tmp_path_factory.mktemp("parallel")
    params = _params()
    data, p1, p2, resample = _data()
    single = _single_ckpt(root / "single" / "single.npz", params, data)
    base = dict(family="sae", params=params, dims=dict(d=D, h=H, k=K), total_steps=20,
                trainer_kw=dict(resample_dead_every=EVERY), pin_chunks=True)
    runs = [
        dict(base, config=_cfg(False), resample=resample, ops=_ops(data, p1, p2)),
        dict(base, config=_cfg(True), ops=[("step", data[:B]), ("fused", data, p1)]),
        dict(base, config=_cfg(False), trainer_kw={},
             ops=[("load", str(root / "single" / "single.npz")), ("step", data[2 * B:3 * B])]),
        dict(base, config=dict(_cfg(False), batch_size=B + 1), ops=[("fused_error", data)]),
    ]
    groups = [(4, "train", root / f"{shape[0]}x{shape[1]}", dict(shape=shape, runs=runs))
              for shape in SHAPES] + [(4, "units", root / "units", dict(pre=_pre(), k=K))]
    *trained, units = ranks.spawn_groups(groups)
    out = dict(zip(SHAPES, trained), units=units)
    out["single_ckpt"] = (root / "single" / "single.npz", single)
    out["data"] = (params, data, p1, p2, resample)
    return out


def _pre():
    rng = np.random.default_rng(7)
    pre = rng.standard_normal((48, 128)).astype(np.float32)
    pre[:4, 10:20] = 1.5  # ties across the shards' boundaries
    pre[4, :] = -1.0  # a row with every value equal and negative
    return pre


def _jmesh(shape):
    return jmesh_mod.make_mesh(*shape, devices=jax.devices()[:4])


class _JReader:
    def __init__(self, arr):
        self.arr, self.num_rows = arr, len(arr)

    def gather(self, idx):
        return self.arr[idx]


_SINGLE: dict = {}


def _jax_run(mesh, params, data, p1, p2, resample, amp, ops, tmp_path, monkeypatch):
    """The JAX trainer on ``mesh`` (None: one device, run once per set of
    ops) through the same ops."""
    key = (amp, len(ops))
    if mesh is None and key in _SINGLE:
        return _SINGLE[key]
    out = _jax_run_uncached(mesh, params, data, p1, p2, resample, amp, ops, tmp_path, monkeypatch)
    if mesh is None:
        _SINGLE[key] = out
    return out


def _jax_run_uncached(mesh, params, data, p1, p2, resample, amp, ops, tmp_path, monkeypatch):

    class Pinned(JSAETrainer):
        def train_epoch_fused(self, data, shuffle=True, seed=None, defer=None, perm=None):
            if perm is None and self._pin:  # an out-of-core chunk: numpy order by step
                perm = np.random.default_rng(self.global_step).permutation(len(data))
            return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, defer=defer,
                                             perm=perm)

    model = JTopKSAE(D, H, K, dead_feature_threshold=3,
                     params={k: jnp.asarray(v) for k, v in params.items()})
    t = Pinned(model, JTrainingConfig(**_cfg(amp)), run_dir=tmp_path, mesh=mesh,
               resample_dead_every=EVERY)
    t._pin = False
    t.setup_scheduler(20)
    if resample is not None:
        t.set_resample_dataset(resample)
    if amp and mesh is None:  # the windowed Pallas epoch in interpret mode, as on the TPU
        monkeypatch.setattr(pallas_sae, "fused_loss_supported", lambda *a: True)
    metrics = []
    with pltpu.force_tpu_interpret_mode():
        for op in ops:
            if op[0] == "step":
                metrics.append(t.train_step(op[1]))
            elif op[0] == "fused":
                metrics.extend(t.train_epoch_fused(op[1], perm=op[2]))
            elif op[0] == "ooc":
                t._pin = True
                metrics.extend(t.train_epoch_out_of_core(_JReader(op[1]), chunk_tokens=op[2]))
                t._pin = False
    return t, metrics


def _jax_params(t) -> dict:
    return {k: np.asarray(v) for k, v in t.model.params.items()}


# ---------------------------------------------------------------------------
# mesh, rules, top-k, all-reduce
# ---------------------------------------------------------------------------


def test_mesh_factorisation_and_errors(port):
    got = port["units"]
    for shape in ((-1, 1), (-1, 4), (2, 2)):
        jm = jmesh_mod.make_mesh(*shape, devices=jax.devices()[:4])
        for r, out in enumerate(got):
            mesh_shape, coords, size = out["shapes"][shape]
            assert mesh_shape == dict(jm.shape) and size == jm.size == 4
            # rank r sits where device r sits in the JAX mesh
            pos = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == jax.devices()[r].id)[0]
            assert coords == tuple(int(i) for i in pos)
    errors = got[0]["errors"]
    assert len(errors) == 3
    for (data, model), msg in zip(((3, 2), (4, 3), (4, 0)), errors):
        with pytest.raises(ValueError) as e:
            jmesh_mod.make_mesh(data, model, devices=jax.devices()[:4])
        assert msg == str(e.value)
    assert got[0]["axes"] == (jmesh_mod.DATA_AXIS, jmesh_mod.MODEL_AXIS)


def test_mesh_needs_a_process_group():
    from whisper_sae_tpu_torch.parallel import make_mesh, mesh_from_config

    with pytest.raises(RuntimeError, match="initialize_if_needed"):
        make_mesh()
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_from_config(MeshConfig())
    assert JMeshConfig().model_dump() == MeshConfig().model_dump()


@pytest.mark.parametrize("shape,dim", [((D, H), 1), ((H, D), 0), ((H,), 0), ((D,), None), ((), None),
                                       ((D, D), None)])
def test_shard_rules(shape, dim):
    from jax.sharding import PartitionSpec as P

    want = jleaf_pspec(shape, D, H)
    assert sharding.leaf_pspec(shape, D, H) == dim
    assert want == {1: P(None, "model"), 0: P("model") if len(shape) == 1 else P("model", None),
                    None: P()}[dim]


def test_place_tree_slices_as_the_jax_mesh_shards(port):
    d, h = 4, 32
    full = {"w_enc": np.arange(d * h, dtype=np.float32).reshape(d, h),
            "w_dec": np.arange(h * d, dtype=np.float32).reshape(h, d),
            "b_enc": np.arange(h, dtype=np.float32), "b_dec": np.ones(d, np.float32),
            "step": np.zeros((), np.float32)}
    placed = jplace_tree(_jmesh((1, 4)), {k: jnp.asarray(v) for k, v in full.items()}, d, h)
    assert sharding.axis_sizes({k: torch.from_numpy(v) for k, v in full.items()}) == (d, h)
    for r, out in enumerate(port["units"]):
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(out["placed"][k], np.asarray(shard.data), err_msg=k)


def test_sharded_threshold_is_the_dense_mask(port):
    """The ranks' blocks of the sharded selection, side by side, are bit
    for bit the single-device dense mask (port and JAX) and JAX's
    sharded one; the gradient goes through the selection only."""
    from jax.sharding import PartitionSpec as P

    from whisper_sae_tpu_torch.ops.topk import topk_mask_plain

    pre = _pre()
    got = np.concatenate([o["hidden"] for o in port["units"]], axis=1)
    dense = topk_mask_plain(torch.from_numpy(pre), K).numpy()
    np.testing.assert_array_equal(got.view(np.int32), dense.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(jtopk_mask_dense(jnp.asarray(pre), K)).view(np.int32))
    jsharded = jax.shard_map(lambda x: jtopk_mask_sharded(x, K, "model"), mesh=_jmesh((1, 4)),
                             in_specs=P(None, "model"), out_specs=P(None, "model"),
                             check_vma=False)(jnp.asarray(pre))
    np.testing.assert_array_equal(got, np.asarray(jsharded))
    grad = np.concatenate([o["hidden_grad"] for o in port["units"]], axis=1)
    np.testing.assert_array_equal(grad, (got > 0).astype(np.float32))


def test_psum_identity_vjp_gradient_is_not_scaled(port):
    from jax.sharding import PartitionSpec as P

    def f(v):
        return jnp.sum(jpsum_identity_vjp(v * 2.0, "model") * jnp.arange(3.0))

    v = jnp.repeat(jnp.arange(1.0, 5.0), 3)  # device r holds r + 1
    jgrad = jax.shard_map(jax.grad(f), mesh=_jmesh((1, 4)), in_specs=P("model"),
                          out_specs=P("model"), check_vma=False)(v)
    for r, out in enumerate(port["units"]):
        np.testing.assert_array_equal(out["psum"], np.full(3, 20.0))
        np.testing.assert_array_equal(out["psum_grad"], 2.0 * np.arange(3.0))
        np.testing.assert_array_equal(out["psum_grad"], np.asarray(jgrad)[3 * r:3 * r + 3])


# ---------------------------------------------------------------------------
# the SAE trained on meshes
# ---------------------------------------------------------------------------


def _check_ranks_agree(results):
    for r in results[1:]:
        assert r["replicated"] == results[0]["replicated"]
        for k in results[0]["params"]:
            np.testing.assert_array_equal(r["params"][k], results[0]["params"][k], err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sae_mesh_run_matches_jax(port, shape, tmp_path, monkeypatch):
    """Steps, two fused epochs with a remainder, resampling per step and at
    an epoch boundary, and a chunked out-of-core epoch (f32)."""
    params, data, p1, p2, resample = port["data"]
    results = [r[0] for r in port[shape]]
    _check_ranks_agree(results)
    got = results[0]
    assert got["tp"] == (shape[1] > 1)
    if got["tp"]:
        assert got["local_shapes"]["w_enc"] == (D, H // shape[1])
    ops = _ops(data, p1, p2)[:-1]
    for mesh in (_jmesh(shape), None):
        jt, jm = _jax_run(mesh, params, data, p1, p2, resample, False, ops,
                          tmp_path / str(mesh is None), monkeypatch)
        assert len(got["losses"]) == len(jm) == got["global_step"] == jt.global_step == 19
        assert got["resampled"] == jt.num_resampled_total > 0
        np.testing.assert_allclose(got["losses"], [m.loss for m in jm], rtol=2e-4)
        np.testing.assert_allclose(got["l0"], [m.l0 for m in jm], atol=1e-2)
        np.testing.assert_allclose(got["dead"], [m.dead_feature_ratio for m in jm], atol=1e-6)
        for k, v in _jax_params(jt).items():
            np.testing.assert_allclose(got["params"][k], v, atol=2e-4, err_msg=k)
        np.testing.assert_array_equal(got["last_activated"],
                                      np.asarray(jt.model.state.feature_last_activated))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sae_mesh_amp_matches_jax(port, shape, tmp_path, monkeypatch):
    params, data, p1, _, _ = port["data"]
    results = [r[1] for r in port[shape]]
    _check_ranks_agree(results)
    ops = [("step", data[:B]), ("fused", data, p1)]
    for mesh in (_jmesh(shape), None):
        _, jm = _jax_run(mesh, params, data, p1, None, None, True, ops,
                         tmp_path / str(mesh is None), monkeypatch)
        np.testing.assert_allclose(results[0]["losses"], [m.loss for m in jm], rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_checkpoint_is_the_single_device_file(port, shape):
    """Rank 0's gathered checkpoint has the single-device file's keys and
    layout and loads into a single-device trainer; a single-device
    checkpoint loads into a mesh run, which then steps as one device does."""
    from whisper_sae_tpu_torch.models.sae import TopKSAE
    from whisper_sae_tpu_torch.utils.checkpoint import load_pytree, params_from_jax

    params, data, *_ = port["data"]
    got = port[shape][0][0]
    single_path, _ = port["single_ckpt"]
    mesh_tree, meta = load_pytree(f"{got['run_dir']}/mesh.npz")
    single_tree, _ = load_pytree(single_path)

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
    t = SAETrainer(TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(params),
                           device="cpu"), TrainingConfig(**_cfg(False)),
                   run_dir=single_path.parent.parent / f"load{shape}")
    t.load_checkpoint(f"{got['run_dir']}/mesh.npz")
    assert t.global_step == got["global_step"]
    np.testing.assert_array_equal(t.model.feature_last_activated.numpy(), got["last_activated"])
    # single -> mesh: the resumed mesh run's step against the single device's
    resumed = port[shape][0][2]
    t2 = SAETrainer(TopKSAE(D, H, K, dead_feature_threshold=3, params=params_from_jax(params),
                            device="cpu"), TrainingConfig(**_cfg(False)),
                    run_dir=single_path.parent.parent / f"resume{shape}")
    t2.load_checkpoint(single_path)
    m = t2.train_step(data[2 * B:3 * B])
    assert resumed["global_step"] == t2.global_step == SINGLE_CKPT_STEPS + 1
    np.testing.assert_allclose(resumed["losses"], [m.loss], rtol=2e-4)
    for k, v in t2.model.params.items():
        np.testing.assert_allclose(resumed["params"][k], v.detach().numpy(), atol=2e-4, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_mesh_epoch_needs_a_batch_split_over_data(port, shape, tmp_path):
    """``batch_size % data axis`` is refused as the JAX package refuses it
    (a one-rank data axis splits any batch)."""
    _, data, *_ = port["data"]
    jt = JSAETrainer(JTopKSAE(D, H, K, seed=0),
                     JTrainingConfig(batch_size=B + 1, learning_rate=1e-3, use_amp=False),
                     run_dir=tmp_path, mesh=_jmesh(shape))
    notes = [r[3]["notes"] for r in port[shape]]
    if shape[0] == 1:
        jt.train_epoch_fused(data, shuffle=False)
        assert notes == [[]] * 4
        return
    with pytest.raises(ValueError) as je:
        jt.train_epoch_fused(data, shuffle=False)
    assert notes == [[str(je.value)]] * 4
