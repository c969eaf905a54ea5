"""Rank processes for the port's parallel tests (``tests/test_torch_port_parallel*.py``).

A test spawns a gloo group of CPU processes with :func:`spawn`; each runs
one scenario of this module (importable, torch and the port only: the
spawned interpreters import no jax) and saves what it returns for the
test, which holds it against the JAX package in its own process.  The
group meets through a ``file://`` rendezvous under the test's temporary
directory (no ports), every process keeps torch to one thread, and every
join and collective has a timeout.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 90


def spawn(world: int, scenario: str, workdir: Path, **kwargs) -> list:
    """Run ``scenario(rank, world, workdir, **kwargs)`` in ``world`` gloo
    ranks; -> each rank's return value, in rank order.  Raises with the
    failing rank's traceback, or when a rank outlives the join timeout."""
    return spawn_groups([(world, scenario, workdir, kwargs)])[0]


def spawn_groups(groups: list) -> list:
    """Several groups of :func:`spawn` at once, each ``(world, scenario,
    workdir, kwargs)`` with its own rendezvous; -> each group's results."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    started = []
    for world, scenario, workdir, kwargs in groups:
        workdir = Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        init = workdir / f"rendezvous_{scenario}"
        init.unlink(missing_ok=True)
        procs = [ctx.Process(target=_rank_main, args=(r, world, str(init), scenario, kwargs,
                                                       str(workdir)))
                 for r in range(world)]
        for p in procs:
            p.start()
        started.append((scenario, workdir, procs))
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for _, _, procs in started:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        hung = [(s, r) for s, _, procs in started for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {JOIN_TIMEOUT_S} s")
    finally:
        for _, _, procs in started:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    out = []
    for scenario, workdir, procs in started:
        failed = [e.read_text() for e in sorted(workdir.glob(f"{scenario}_*.err"))]
        if failed or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"{scenario}: exit codes {[p.exitcode for p in procs]}\n"
                               + "\n".join(failed))
        results = []
        for r in range(len(procs)):
            with open(workdir / f"{scenario}_{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        out.append(results)
    return out


def _rank_main(rank: int, world: int, init: str, scenario: str, kwargs: dict, workdir: str):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from whisper_sae_tpu_torch.parallel import initialize_if_needed

    try:
        env = kwargs.pop("env", None)
        if env is not None:
            os.environ.update({k: v.format(rank=rank) for k, v in env.items()})
        initialize_if_needed(f"file://{init}", world, rank, backend="gloo",
                             timeout_s=GROUP_TIMEOUT_S)
        result = globals()[scenario](rank, world, Path(workdir), **kwargs)
        with open(Path(workdir) / f"{scenario}_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        # no rank tears the group down while another still finishes a collective
        dist.barrier()
    except BaseException:
        (Path(workdir) / f"{scenario}_{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def units(rank, world, workdir, pre: np.ndarray, k: int):
    """Mesh factorisation and errors, the shard rules' slices, the sharded
    threshold on this rank's feature block, and psum_identity_vjp's
    gradient, on a group of ``world`` ranks."""
    from whisper_sae_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, make_mesh
    from whisper_sae_tpu_torch.parallel.sharding import place_tree
    from whisper_sae_tpu_torch.parallel.tp_step import psum_identity_vjp
    from whisper_sae_tpu_torch.parallel.tp_topk import topk_mask_sharded

    out = {"shapes": {}, "errors": []}
    for data, model in ((-1, 1), (-1, world), (world // 2, 2)):
        mesh = make_mesh(data, model)
        out["shapes"][(data, model)] = (dict(mesh.shape), mesh.coords, mesh.size)
    for data, model in ((3, 2), (world, 3), (world, 0)):
        try:
            make_mesh(data, model)
        except ValueError as e:
            out["errors"].append(str(e))
    mesh = make_mesh(-1, world)  # every rank on the model axis
    d, h = 4, 8 * world
    full = {"w_enc": torch.arange(d * h, dtype=torch.float32).reshape(d, h),
            "w_dec": torch.arange(h * d, dtype=torch.float32).reshape(h, d),
            "b_enc": torch.arange(h, dtype=torch.float32), "b_dec": torch.ones(d),
            "step": torch.zeros(())}
    out["placed"] = {k: _np(v) for k, v in place_tree(mesh, full, d, h).items()}
    x = torch.from_numpy(pre)
    block = mesh.feature_block(x.shape[1])
    local = x[:, block].clone().requires_grad_(True)
    hidden = topk_mask_sharded(local, k, mesh.model_group)
    out["hidden"] = _np(hidden)
    hidden.sum().backward()
    out["hidden_grad"] = _np(local.grad)
    v = torch.full((3,), float(rank + 1), requires_grad=True)
    s = psum_identity_vjp(v * 2.0, mesh.model_group)
    (s * torch.arange(3.0)).sum().backward()
    out["psum"], out["psum_grad"] = _np(s), _np(v.grad)
    out["axes"] = (DATA_AXIS, MODEL_AXIS)
    return out


def _family_model(family: str, params: dict, dims: dict, dev="cpu"):
    from whisper_sae_tpu_torch.models.crosscoder import CrossLayerCrosscoder, TopKCrossLayerCrosscoder
    from whisper_sae_tpu_torch.models.sae import ReLUSAE, TopKSAE
    from whisper_sae_tpu_torch.models.transcoder import SkipTranscoder, TopKTranscoder
    from whisper_sae_tpu_torch.training.coder_trainers import CrosscoderTrainer, TranscoderTrainer
    from whisper_sae_tpu_torch.training.trainer import SAETrainer
    from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

    p = params_from_jax(params)
    thr = dims.get("threshold", 3)
    if family == "sae":
        return TopKSAE(dims["d"], dims["h"], dims["k"], dead_feature_threshold=thr, params=p,
                       device=dev), SAETrainer
    if family == "relu_sae":
        return ReLUSAE(dims["d"], dims["h"], sparsity_weight=dims.get("sparsity_weight", 0.01),
                       params=p, device=dev), SAETrainer
    if family in ("transcoder", "skip_transcoder"):
        cls = SkipTranscoder if family == "skip_transcoder" else TopKTranscoder
        return cls(dims["d"], dims["dout"], dims["h"], k=dims["k"], dead_feature_threshold=thr,
                   params=p, device=dev), TranscoderTrainer
    if family == "crosscoder":
        return TopKCrossLayerCrosscoder(dims["d"], dims["layers"], dims["h"], k=dims["k"],
                                        dead_feature_threshold=thr, params=p,
                                        device=dev), CrosscoderTrainer
    if family == "relu_crosscoder":
        return CrossLayerCrosscoder(dims["d"], dims["layers"], dims["h"],
                                    dead_feature_threshold=thr, params=p,
                                    device=dev), CrosscoderTrainer
    raise ValueError(family)


def _replicated_bits(trainer) -> dict:
    """The bits of every leaf this rank holds whole (the test compares
    them across ranks)."""
    specs = trainer._tp_family().param_specs if trainer._is_tp() else None
    return {k: _np(v).tobytes() for k, v in trainer.model.params.items()
            if specs is None or specs[k] is None}


def train(rank, world, workdir, shape, runs: list):
    """Each run trains one family on the ``shape`` mesh through the
    trainer's public API and returns its metrics, full parameters and dead
    counters (gathered), the replicated leaves' bits, and what the run's
    ops report.  A run: family, params (JAX layout), dims, config kwargs,
    resample rows (or None), and ops -- ("step", batch), ("fused", data,
    perm or None), ("ooc", data, chunk), ("save", name), ("load", name)."""
    from whisper_sae_tpu_torch.config import TrainingConfig
    from whisper_sae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(*shape)
    results = []
    for i, run in enumerate(runs):
        model, cls = _family_model(run["family"], run["params"], run["dims"])
        if run.get("pin_chunks"):
            cls = _pinned(cls)
        trainer = cls(model, TrainingConfig(**run["config"]), run_dir=workdir / f"run{i}_{shape}",
                      mesh=mesh, **run.get("trainer_kw", {}))
        if run.get("total_steps"):
            trainer.setup_scheduler(run["total_steps"])
        if run.get("resample") is not None:
            trainer.set_resample_dataset(run["resample"])
        metrics, notes = [], []
        for op in run["ops"]:
            kind = op[0]
            if kind == "step":
                metrics.append(trainer.train_step(op[1]))
            elif kind == "fused":
                metrics.extend(trainer.train_epoch_fused(op[1], perm=op[2], shuffle=op[2] is not None))
            elif kind == "ooc":
                trainer._pin = True
                metrics.extend(trainer.train_epoch_out_of_core(_ArrayReader(op[1]), chunk_tokens=op[2]))
                trainer._pin = False
            elif kind == "save":
                trainer.save_checkpoint(op[1])
            elif kind == "load":
                trainer.load_checkpoint(op[1])
            elif kind == "fused_error":
                try:
                    trainer.train_epoch_fused(op[1], shuffle=False)
                except ValueError as e:
                    notes.append(str(e))
        full = trainer.full_params()
        ds = trainer._gathered()[2]
        results.append({
            "losses": [m.loss for m in metrics], "l0": [m.l0 for m in metrics],
            "dead": [m.dead_feature_ratio for m in metrics],
            "sparsity": [m.sparsity_loss for m in metrics],
            "params": {k: _np(v) for k, v in full.items()},
            "last_activated": _np(ds.feature_last_activated),
            "replicated": _replicated_bits(trainer), "tp": trainer._is_tp(),
            "local_shapes": {k: tuple(v.shape) for k, v in trainer.model.params.items()},
            "moment_shapes": {k: (tuple(m.shape), tuple(v.shape)) for (k, m), v in
                              zip(trainer.opt_state.mu.items(), trainer.opt_state.nu.values())},
            "global_step": trainer.global_step, "resampled": trainer.num_resampled_total,
            "notes": notes, "run_dir": str(trainer.run_dir),
        })
    return results


def _pinned(cls):
    """``cls`` whose out-of-core chunks train in a numpy order drawn by the
    step the chunk starts at (the JAX side pins the same order)."""

    class Pinned(cls):
        _pin = False

        def train_epoch_fused(self, data, shuffle=True, seed=None, perm=None):
            if perm is None and self._pin:
                n = (data[0] if isinstance(data, tuple) else data).shape[0]
                perm = np.random.default_rng(self.global_step).permutation(n)
            return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, perm=perm)

    return Pinned


class _ArrayReader:
    def __init__(self, arr):
        self.arr = torch.from_numpy(arr)
        self.num_rows = len(arr)

    def gather(self, idx):
        return self.arr[torch.from_numpy(np.asarray(idx))]


def extract(rank, world, workdir, params, arch: dict, clips: int, batch: int, compute: str,
            out: str, data_mesh: int):
    """dp extraction of ``clips`` synthetic clips in batches of ``batch``
    over a ``(data_mesh, world // data_mesh)`` mesh into ``workdir/out``."""
    from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig
    from whisper_sae_tpu_torch.data import feature_cache as tfc
    from whisper_sae_tpu_torch.data import librispeech as tls
    from whisper_sae_tpu_torch.models import whisper as TW
    from whisper_sae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data_mesh, world // data_mesh)
    cache = tfc.FeatureCache(workdir / out, WhisperConfig(),
                             DataConfig(dataset_name="synthetic", max_samples=clips))
    loader = tls.AudioBatchLoader(tls.LibriSpeechFeaturesOnly(tls.SyntheticSpeechDataset(clips, seed=3)),
                                  batch_size=batch)
    tfc.extract_and_cache_features(
        TW.params_from_jax(params), TW.WhisperArch(**arch), loader, cache, encoder_layers=[1],
        decoder_layers=[0, 1], max_samples=clips, progress=False, capture_mlp=True,
        compute_dtype=torch.bfloat16 if compute == "bf16" else None, mesh=mesh)
    return sorted(p.name for p in (workdir / out).iterdir())


def cli(rank, world, workdir, argv: list, params: dict):
    """The port's CLI (``whisper_sae_tpu_torch.train.main``) in a rank whose
    environment is torchrun's, with the SAE's initial parameters and each
    epoch's order pinned (numpy, by the step the epoch starts at: the JAX
    side pins the same)."""
    from whisper_sae_tpu_torch import train as cli_mod
    from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

    real_create = cli_mod.create_sae

    def create(c, input_dim, seed=0, device=None):
        sae = real_create(c, input_dim, seed=seed, device=device)
        sae.load_params(params_from_jax(params))
        return sae

    class Pinned(cli_mod.SAETrainer):
        def train_epoch_fused(self, data, shuffle=True, seed=None, perm=None):
            n = (data[0] if isinstance(data, tuple) else data).shape[0]
            perm = np.random.default_rng(self.global_step).permutation(n)
            return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, perm=perm)

    cli_mod.create_sae, cli_mod.SAETrainer = create, Pinned
    (trainer,) = cli_mod.main(argv).values()
    return {"mesh": dict(trainer.mesh.shape), "global_step": trainer.global_step,
            "run_dir": str(trainer.run_dir), "rank_env": os.environ["RANK"],
            "device": str(trainer.device)}


def launch_jobs(rank, world, workdir, argvs: list):
    """``whisper_sae_tpu_torch.launch.main`` on each argv in turn, in a rank
    whose environment is torchrun's."""
    from whisper_sae_tpu_torch import launch

    return [launch.main(a) for a in argvs]
