"""SAE trainer (counterpart of ``whisper_sae_tpu/training/trainer.py``).

Each step, as in the JAX package (``trainer.py:267-288``): forward,
backward, global-norm clip 1.0 with optax's rule (``g * max/|g|`` when
``|g| >= max``), AdamW (b1=0.9, b2=0.999, eps=1e-8, decoupled weight
decay, update ``t`` at ``lr(t)`` with ``t`` counted from 0), decoder
renorm, dead-feature update, metrics.  The step's products run with TF32
off, set around the step rather than for the whole process.

The family lives in hooks, as in the JAX package: ``_loss_fn`` (loss and
an aux with reconstruction_loss, sparsity_loss, l0 and active),
``_prepare_batch``, ``_renorm_params``/``_should_renorm``,
``_use_indexed_epoch``, ``_indexed_prepare`` and ``_indexed_loss_fn``.
This class trains the TopK SAE (kernel A, or the composed loss around the
top-k encode) and the ReLU SAE (the coder kernel in ReLU mode);
``coder_trainers.py`` overrides the hooks for transcoders and
crosscoders.

The fused epoch (``train_epoch_fused``) keeps the epoch buffer (or the
``(x, y)`` pair of buffers) on the device, gathered once by the
permutation; under AMP, where the family's kernel holds the geometry
(``_use_indexed_epoch``), each step runs that kernel at a row offset into
the buffer (the port of ``fused_sae_loss_indexed`` and the ``*_indexed``
coder entries); otherwise each step hands ``_loss_fn`` a slice view of
the buffer (whisper-tiny 128x, whisper-large: the composed loss around
the top-k encode).  Metrics stay on the device and are
fetched once per epoch; the remainder batch goes through ``train_step``.
``train_epochs_fused`` chains several such epochs with one fetch for all
of them, and ``train()`` chains its fused epochs up to each checkpoint.

With a ``mesh`` (``parallel.make_mesh``: one process per GPU, every rank
with the same config, seed and data), each data rank steps on its
contiguous block of every batch.  A family with a dp x tp form
(``_supports_tp``: the TopK and ReLU SAEs, the transcoders, the
crosscoders) on a mesh whose ``model`` axis is above 1 holds its block
of the features (parameters, AdamW moments, dead counters) and
runs ``parallel/tp_step.py``'s step; every other case is the dp step: the
family's own loss (its kernel) on the rank's rows, then one all-reduce
of the gradients over ``data``, parameters replicated.  Resampling
gathers the full parameters on every rank and draws the same rows;
checkpoints are the single-device file, written by rank 0, which alone
writes ``metrics.json`` and the console.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import TrainingConfig
from ..models.sae import (
    DeadFeatureState,
    ReLUSAE,
    TopKSAE,
    dead_feature_mask,
    init_dead_state,
    relu_sae_loss,
    topk_sae_loss,
    update_dead_state,
)
from ..ops.cuda_coder import coder_supported, fused_relu_sae_loss_indexed
from ..ops.cuda_sae import fused_loss_supported, fused_sae_loss_indexed
from ..utils.checkpoint import export_torch_state_dict, load_pytree, save_pytree
from ..utils.device import f32_matmuls
from ..utils.profiling import span
from .schedule import constant_schedule, warmup_cosine_schedule

_METRIC_KEYS = ("loss", "reconstruction_loss", "sparsity_loss", "l0", "dead_feature_ratio")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainingMetrics:
    """Per-step metrics (the ``metrics.json`` row)."""

    loss: float
    reconstruction_loss: float
    sparsity_loss: float
    l0: float
    dead_feature_ratio: float
    learning_rate: float
    step: int


class AdamWState(NamedTuple):
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int  # updates applied; the schedule and bias correction read it


def init_adamw(params: dict[str, torch.Tensor], count: int = 0) -> AdamWState:
    zeros = {k: torch.zeros_like(v, memory_format=torch.contiguous_format) for k, v in params.items()}
    return AdamWState(zeros, {k: torch.zeros_like(v) for k, v in zeros.items()}, count)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float) -> dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when ``|g| < max``, else
    ``(g / |g|) * max`` (no ``+ eps`` in the divisor)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, (g / g_norm) * max_norm) for k, g in grads.items()}


@torch.no_grad()
def adamw_update_(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                  state: AdamWState, lr: float, weight_decay: float) -> AdamWState:
    """optax.adamw in place: moments, bias correction at ``count + 1``,
    ``m / (sqrt(v) + eps)``, ``+ wd * p``, then ``p += -lr * update``."""
    count = state.count + 1
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
    for name, p in params.items():
        g = grads[name]
        mu = state.mu[name].mul_(_B1).add_(g * (1.0 - _B1))
        nu = state.nu[name].mul_(_B2).add_(g * g * (1.0 - _B2))
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
        if weight_decay:
            update = update + weight_decay * p
        p.add_(update.mul_(-lr))
    return AdamWState(state.mu, state.nu, count)


def _tree(fn, data):
    """``fn`` on a tensor or on each tensor of a tuple of them."""
    return tuple(fn(a) for a in data) if isinstance(data, tuple) else fn(data)


def _zero_aux(loss: torch.Tensor, aux: dict) -> dict:
    """The aux of a family without a sparsity term."""
    return {"reconstruction_loss": loss, "sparsity_loss": torch.zeros_like(loss), **aux}


class SAETrainer:
    """Trainer for a :class:`TopKSAE` or :class:`ReLUSAE` on the model's
    device; the base of the coder trainers."""

    def __init__(
        self,
        model,
        config: TrainingConfig,
        run_dir: Path | None = None,
        resample_dead_every: int = 5000,
        resample_batch_size: int = 8192,
        mesh=None,
    ):
        self.model = model
        self.mesh = mesh
        self.config = config
        self.device = model.device
        self.run_dir = Path(run_dir) if run_dir is not None else Path("outputs")
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.resample_dead_every = resample_dead_every
        self.resample_batch_size = resample_batch_size
        self.compute_dtype = torch.bfloat16 if config.use_amp else torch.float32
        self._schedule = constant_schedule(config.learning_rate)
        self._total_steps: int | None = None
        self.opt_state = init_adamw(model.params)
        self.global_step = 0
        self.epoch = 0
        self.metrics_history: list[TrainingMetrics] = []
        self.num_resampled_total = 0
        self.wandb_run = None
        self._resample_dataset = None
        self._resample_rng = np.random.default_rng(config.seed)
        self.threshold = getattr(model, "dead_feature_threshold", 10_000)
        # dead-feature counters of a model that keeps none of its own
        self._own_dead = None if hasattr(model, "state") else init_dead_state(
            model.hidden_dim, self.device)
        # the model holds this rank's feature blocks (dp x tp); resampling
        # and checkpoint loads put full tensors back and clear the latch
        self._mesh_placed = False
        self._tp_steps: dict = {}

    # ------------------------------------------------------------------
    # schedule
    # ------------------------------------------------------------------

    def setup_scheduler(self, total_steps: int) -> None:
        """Install the warmup -> cosine schedule; AdamW moments and count
        carry over."""
        self._total_steps = total_steps
        self._schedule = warmup_cosine_schedule(
            self.config.learning_rate, total_steps, self.config.warmup_steps
        )

    def learning_rate_at(self, step: int) -> float:
        return float(np.asarray(self._schedule(step)))

    def learning_rates_at(self, start: int, count: int) -> np.ndarray:
        return np.asarray(self._schedule(np.arange(start, start + count)))

    # ------------------------------------------------------------------
    # family hooks
    # ------------------------------------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device).contiguous()

    def _prepare_batch(self, batch):
        """A batch as the loss takes it: the rows, on the device (a
        1-tuple, as a TensorDataset yields, is unwrapped)."""
        if isinstance(batch, (tuple, list)):
            batch = batch[0]
        return self._to_device(batch)

    def _loss_fn(self, params, batch):
        """(loss, aux with reconstruction_loss, sparsity_loss, l0, active)."""
        if isinstance(self.model, ReLUSAE):
            return relu_sae_loss(params, batch, self.model.sparsity_weight, self.compute_dtype)
        loss, aux = topk_sae_loss(params, batch, self.model.k, self.compute_dtype)
        return loss, _zero_aux(loss, aux)

    def _should_renorm(self) -> bool:
        return getattr(self.model, "normalize_decoder", True)

    def _renorm_params(self) -> None:
        """The family's decoder-norm invariant, in place."""
        self.model.normalize_decoder_weights()

    def _use_indexed_epoch(self) -> bool:
        """The windowed epoch (``trainer.py:613-635`` of the JAX package):
        under AMP, where the family's kernel holds the geometry."""
        if self.compute_dtype != torch.bfloat16:
            return False
        d, h = self.model.input_dim, self.model.hidden_dim
        if isinstance(self.model, ReLUSAE):
            return coder_supported(d, d, h)
        return fused_loss_supported(d, h)

    def _indexed_prepare(self, sel):
        """The gathered epoch buffer(s) in the kernel's layout (the
        crosscoder flattens [N, L, D])."""
        return sel

    def _indexed_loss_fn(self, params, sel, step: int):
        """``_loss_fn`` over rows ``[step*B, (step+1)*B)`` of the epoch
        buffer (B this rank's rows a step), read by the family's kernel at
        a row offset."""
        b = self._local_batch
        p = params
        if isinstance(self.model, ReLUSAE):
            loss, recon, sparsity, l0, active = fused_relu_sae_loss_indexed(
                sel, step, p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"],
                float(self.model.sparsity_weight), b)
            return loss, {"reconstruction_loss": recon, "sparsity_loss": sparsity, "l0": l0,
                          "active": active}
        loss, l0, active = fused_sae_loss_indexed(
            sel, step, p["w_enc"], p["b_enc"], p["b_pre"], p["w_dec"], p["b_dec"], self.model.k, b)
        return loss, _zero_aux(loss, {"l0": l0, "active": active})

    @property
    def _dead_state(self) -> DeadFeatureState:
        return self.model.state if self._own_dead is None else self._own_dead

    @_dead_state.setter
    def _dead_state(self, value: DeadFeatureState) -> None:
        if self._own_dead is None:
            self.model.state = value
        else:
            self._own_dead = value

    # ------------------------------------------------------------------
    # the mesh (trainer.py:213-257 of the JAX package)
    # ------------------------------------------------------------------

    def _supports_tp(self) -> bool:
        """Whether the family has a dp x tp form (``parallel/tp_step.py``);
        the coder trainers override.  Both SAEs have one: the JAX package
        places them by its shape rules under GSPMD, which the port writes
        out as a family."""
        return isinstance(self.model, (TopKSAE, ReLUSAE))

    def _tp_family(self):
        from ..parallel.tp_step import relu_sae_family, sae_family

        if isinstance(self.model, ReLUSAE):
            return relu_sae_family(self.model.sparsity_weight)
        return sae_family(self.model.k)

    def _is_tp(self) -> bool:
        if self.mesh is None:
            return False
        from ..parallel.mesh import MODEL_AXIS

        return self.mesh.shape[MODEL_AXIS] > 1 and self._supports_tp()

    @property
    def _n_data(self) -> int:
        from ..parallel.mesh import DATA_AXIS

        return 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

    @property
    def _local_batch(self) -> int:
        """The rows of a batch each step of this rank takes."""
        return self.config.batch_size // self._n_data

    @property
    def is_primary(self) -> bool:
        """The rank that writes checkpoints, metrics and the console."""
        return self.mesh is None or self.mesh.rank == 0

    @torch.no_grad()
    def _assign(self, params: dict, dstate: DeadFeatureState) -> None:
        """Give the model these tensors (of any shape) as its parameters
        and dead-feature counters."""
        for name, t in params.items():
            setattr(self.model, name, nn.Parameter(t))
        if self._own_dead is None:
            self.model.feature_last_activated = dstate.feature_last_activated
            self.model.step_count = dstate.step_count
        else:
            self._own_dead = dstate

    def _place_on_mesh(self) -> None:
        """Under dp x tp, the model's parameters, AdamW moments and
        dead-feature counters become this rank's feature blocks.
        Idempotent through ``_mesh_placed``; dp state stays replicated."""
        if self.mesh is None or self._mesh_placed:
            return
        if self._is_tp():
            from ..parallel.tp_step import place_for_tp

            params, self.opt_state, dstate = place_for_tp(
                self.mesh, self._tp_family(), self.model.params, self.opt_state, self._dead_state)
            self._assign(params, dstate)
        self._mesh_placed = True

    def _gathered(self) -> tuple[dict, AdamWState, DeadFeatureState]:
        """(parameters, AdamW state, dead-feature state), full, on every
        rank (gathered over the mesh's CPU group when placed dp x tp)."""
        params = {k: v.detach() for k, v in self.model.params.items()}
        if not (self._mesh_placed and self._is_tp()):
            return params, self.opt_state, self._dead_state
        from ..parallel.sharding import gather_leaf, gather_tree

        specs = self._tp_family().param_specs
        ds = self._dead_state
        return (gather_tree(self.mesh, params, specs),
                AdamWState(gather_tree(self.mesh, self.opt_state.mu, specs),
                           gather_tree(self.mesh, self.opt_state.nu, specs), self.opt_state.count),
                DeadFeatureState(gather_leaf(self.mesh, ds.feature_last_activated, 0),
                                 ds.step_count))

    def _unplace(self) -> None:
        """The full state back in the model on every rank; the next step
        places it again."""
        if self._mesh_placed and self._is_tp():
            params, self.opt_state, dstate = self._gathered()
            self._assign(params, dstate)
        self._mesh_placed = False

    def full_params(self) -> dict[str, torch.Tensor]:
        """The model's parameters, whole, on every rank."""
        return self._gathered()[0]

    def _lr_at_count(self, count: int) -> float:
        return float(np.asarray(self._schedule(count)))

    def _tp_step(self, batch, reduce_data: bool = True) -> torch.Tensor:
        """One dp x tp step (``parallel/tp_step.py``) on this rank's rows of
        ``batch`` (with ``reduce_data=False``: on all of them, reducing
        nothing over ``data``) -> the step's [5] metric row."""
        if reduce_data not in self._tp_steps:
            from ..parallel.tp_step import build_tp_train_step

            self._tp_steps[reduce_data] = build_tp_train_step(
                self._tp_family(), self.compute_dtype, self.mesh, self.threshold,
                self._lr_at_count, self.config.weight_decay, renorm=self._should_renorm(),
                gradient_clip=self.config.gradient_clip, reduce_data=reduce_data)
        self.opt_state, dstate, row = self._tp_steps[reduce_data](
            self.model.params, self.opt_state, self._dead_state, batch)
        self._dead_state = dstate
        return row

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    @span("train.step")
    def _step(self, loss_call, reduce: bool = False) -> torch.Tensor:
        """One optimizer step, all on the device.  Returns the step's
        ``_METRIC_KEYS`` as one [5] tensor (no host synchronisation).
        ``reduce``: the dp step -- the gradients, with the metrics and the
        active vector in the same buffer, all-reduced over ``data``.
        Spans: ``train.step``, and inside it ``train.backward`` and
        ``train.update`` (everything after the backward)."""
        params = self.model.params
        with f32_matmuls():
            loss, aux = loss_call(params)
            with span("train.backward"):
                grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad(), span("train.update"):
            loss, recon, sparsity = (loss.detach(), aux["reconstruction_loss"].detach(),
                                     aux["sparsity_loss"].detach())
            l0, active = aux["l0"].float(), aux["active"]
            if reduce:
                from ..parallel.sharding import reduce_gradients

                sums = torch.cat([torch.stack([loss, recon, sparsity, l0]), active.float()])
                grads, sums = reduce_gradients(self.mesh, grads, sums)
                loss, recon, sparsity, l0 = sums[:4] / self._n_data
                active = sums[4:] > 0
            grads = clip_by_global_norm(grads, self.config.gradient_clip)
            lr = self._lr_at_count(self.opt_state.count)
            self.opt_state = adamw_update_(params, grads, self.opt_state, lr, self.config.weight_decay)
            if self._should_renorm():
                self._renorm_params()
            self._dead_state = update_dead_state(self._dead_state, active)
            dead = dead_feature_mask(self._dead_state, self.threshold).float().mean()
            return torch.stack([loss, recon, sparsity, l0, dead])

    def _window_loss(self, sel, step: int, indexed: bool):
        """Loss over rows ``[step*B, (step+1)*B)`` of the epoch buffer (B
        this rank's rows a step): the family's kernel at a row offset when
        ``indexed``, else ``_loss_fn`` on a slice view (no copy)."""
        if indexed:
            return lambda p: self._indexed_loss_fn(p, sel, step)
        b = self._local_batch
        rows = _tree(lambda a: a[step * b:(step + 1) * b], sel)
        return lambda p: self._loss_fn(p, rows)

    def _mesh_step(self, x) -> torch.Tensor:
        """``train_step``'s step under a mesh: this rank's block of the
        batch, or, when the rows do not split over ``data``, the whole
        batch on every rank at single-device semantics (no data
        all-reduce; ``trainer.py:365-392`` of the JAX package)."""
        self._place_on_mesh()
        rows = (x[0] if isinstance(x, tuple) else x).shape[0]
        if rows % self._n_data:
            if self._is_tp():
                return self._tp_step(x, reduce_data=False)
            return self._step(lambda p: self._loss_fn(p, x))
        block = self.mesh.row_block(rows)
        local = _tree(lambda a: a[block], x)
        if self._is_tp():
            return self._tp_step(local)
        return self._step(lambda p: self._loss_fn(p, local), reduce=True)

    def train_step(self, batch) -> TrainingMetrics:
        """One optimizer step on one batch."""
        x = self._prepare_batch(batch)
        lr = self.learning_rate_at(self.global_step)
        if self.mesh is None:
            row = self._step(lambda p: self._loss_fn(p, x))
        else:
            row = self._mesh_step(x)
        self.global_step += 1
        self._maybe_resample_dead_features()
        values = dict(zip(_METRIC_KEYS, row.tolist()))
        return TrainingMetrics(**values, learning_rate=lr, step=self.global_step)

    # ------------------------------------------------------------------
    # dead-feature resampling
    # ------------------------------------------------------------------

    def set_resample_dataset(self, dataset) -> None:
        """Rows ([N, D] array or tensor) that resampling draws from."""
        self._resample_dataset = dataset if isinstance(dataset, torch.Tensor) else np.asarray(dataset)

    def _resample_from_dataset(self) -> int:
        n_rows = len(self._resample_dataset)
        n = min(self.resample_batch_size, n_rows)
        idx = self._resample_rng.permutation(n_rows)[:n]
        if isinstance(self._resample_dataset, torch.Tensor):
            idx = torch.from_numpy(idx)
        return self.model.resample_dead_features(self._resample_dataset[idx])

    def _maybe_resample_dead_features(self) -> int:
        if self._resample_dataset is None or not hasattr(self.model, "resample_dead_features"):
            return 0
        if self.global_step == 0 or self.global_step % self.resample_dead_every != 0:
            return 0
        # under dp x tp every rank gathers the full state and draws the same
        # rows from the same stream, then takes its blocks back
        self._unplace()
        num = self._resample_from_dataset()
        self._place_on_mesh()
        if num > 0:
            # resampling rewrites whole feature rows: restart all AdamW
            # moments, keeping the count (schedule position)
            self.opt_state = init_adamw(self.model.params, count=self.global_step)
            self.num_resampled_total += num
            if self.wandb_run is not None:
                self.wandb_run.log({"train/features_resampled": num}, step=self.global_step)
        return num

    def _force_resample(self) -> int:
        """Resample at an epoch boundary that crossed a multiple of
        ``resample_dead_every``.  As in the JAX package, the moment restart
        inside runs with ``global_step`` set to ``resample_dead_every``."""
        saved = self.global_step
        try:
            self.global_step = self.resample_dead_every
            return self._maybe_resample_dead_features()
        finally:
            self.global_step = saved

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    @span("train.order")
    def _epoch_permutation(self, n: int, seed: int | None, epoch: int | None = None
                           ) -> torch.Tensor:
        """The order of epoch ``epoch`` (``self.epoch`` by default), drawn
        on the host and uploaded (span ``train.order``)."""
        base = self.config.seed if seed is None else seed
        epoch = self.epoch if epoch is None else epoch
        mixed = int(np.random.SeedSequence([base, epoch]).generate_state(1)[0])
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(mixed))
        return perm.to(self.device)

    def _convert_metrics(self, start_step: int, host: np.ndarray) -> list[TrainingMetrics]:
        lrs = self.learning_rates_at(start_step, host.shape[0])
        return [
            TrainingMetrics(
                **{k: float(v) for k, v in zip(_METRIC_KEYS, row)},
                learning_rate=float(lrs[i]),
                step=start_step + i + 1,
            )
            for i, row in enumerate(host)
        ]

    def _fused_steps(self, data, perm, steps: int) -> torch.Tensor:
        """The epoch's ``steps`` full batches of device-resident ``data`` in
        the order ``perm`` (None: as stored), with no host synchronisation;
        -> the steps' metric rows [steps, 5], on the device.  Under a mesh
        this rank's buffer holds its block of each batch, in step order."""
        b = self.config.batch_size
        if self.mesh is None:
            sel = _tree(lambda a: a[perm[:steps * b]] if perm is not None else a[:steps * b], data)
        else:
            if b % self._n_data:
                raise ValueError(f"fused mesh epochs need batch_size % data axis == 0 "
                                 f"(got {b} % {self._n_data})")
            self._place_on_mesh()
            first = data[0] if isinstance(data, tuple) else data
            order = perm[:steps * b] if perm is not None else torch.arange(
                steps * b, device=first.device)
            idx = order.view(steps, b)[:, self.mesh.row_block(b)].reshape(-1)
            sel = _tree(lambda a: a[idx], data)
        if self._is_tp():
            from ..parallel.tp_step import build_tp_epoch_fn

            bl = self._local_batch
            epoch = build_tp_epoch_fn(
                self._tp_family(), self.compute_dtype, self.mesh, self.threshold,
                self._lr_at_count, self.config.weight_decay, _METRIC_KEYS,
                renorm=self._should_renorm(), gradient_clip=self.config.gradient_clip)
            batches = _tree(lambda a: a.view(steps, bl, *a.shape[1:]), sel)
            self.opt_state, dstate, rows = epoch(self.model.params, self.opt_state,
                                                 self._dead_state, batches)
            self._dead_state = dstate
        else:
            indexed = self._use_indexed_epoch()
            if indexed:  # the windowed kernel's layout
                sel = self._indexed_prepare(sel)
            rows = torch.stack([self._step(self._window_loss(sel, s, indexed),
                                           reduce=self.mesh is not None) for s in range(steps)])
        self.global_step += steps
        return rows

    def _log_epochs(self, metrics: list[TrainingMetrics]) -> None:
        self.metrics_history.extend(metrics)
        if self.wandb_run is not None:
            for m in metrics:
                if m.step % 100 == 0:
                    self._log_wandb(m)

    def train_epoch_fused(self, data, shuffle: bool = True, seed: int | None = None,
                          perm=None) -> list[TrainingMetrics]:
        """One epoch over device-resident rows.

        ``perm``: an explicit [N] batch order (overrides the shuffle), so a
        run can replay another trainer's order.  Resampling fires at the
        epoch boundary if the step count crossed a multiple of
        ``resample_dead_every``."""
        b = self.config.batch_size
        data = _tree(self._to_device, data)
        n = (data[0] if isinstance(data, tuple) else data).shape[0]
        steps = n // b
        if perm is not None:
            if not isinstance(perm, torch.Tensor):
                perm = torch.from_numpy(np.asarray(perm))
            perm = perm.to(self.device, torch.long)
        elif shuffle:
            perm = self._epoch_permutation(n, seed)
        epoch_metrics: list[TrainingMetrics] = []

        if steps > 0:
            start_step = self.global_step
            host = self._fused_steps(data, perm, steps).cpu().numpy()  # the epoch's one fetch
            epoch_metrics.extend(self._convert_metrics(start_step, host))
            if (
                self._resample_dataset is not None
                and self.global_step // self.resample_dead_every
                > start_step // self.resample_dead_every
            ):
                self._force_resample()

        if n % b:
            tail = _tree(lambda a: a[perm[steps * b:]] if perm is not None else a[steps * b:], data)
            epoch_metrics.append(self.train_step(tail))

        self._log_epochs(epoch_metrics)
        self.epoch += 1
        return epoch_metrics

    def train_epochs_fused(self, data, epochs: int, shuffle: bool = True,
                           seed: int | None = None) -> list[TrainingMetrics]:
        """``epochs`` fused epochs chained on the device (``trainer.py:942-1010``
        of the JAX package): each epoch's steps are queued behind the last
        one's with no host fetch between them, and the epochs' metric rows,
        kept on the device, are fetched once at the end.  The epochs' orders
        are uploaded before the first step; each is the one
        :meth:`train_epoch_fused` draws at that epoch, so the parameters and
        metrics are the sequential loop's bit for bit.  Falls back to that
        loop where an epoch boundary needs the host: a remainder batch
        (``n % b``, ``n < b``), a resample dataset, or a mesh, as the JAX
        package does."""
        b = self.config.batch_size
        data = _tree(self._to_device, data)
        n = (data[0] if isinstance(data, tuple) else data).shape[0]
        if n % b or n < b or self._resample_dataset is not None or self.mesh is not None:
            out: list[TrainingMetrics] = []
            for _ in range(epochs):
                out.extend(self.train_epoch_fused(data, shuffle=shuffle, seed=seed))
            return out
        steps = n // b
        perms = [self._epoch_permutation(n, seed, self.epoch + e) if shuffle else None
                 for e in range(epochs)]
        starts, rows = [], []
        for perm in perms:
            starts.append(self.global_step)
            rows.append(self._fused_steps(data, perm, steps))
            self.epoch += 1
        host = torch.stack(rows).cpu().numpy()  # the one fetch
        metrics = [m for start, h in zip(starts, host) for m in self._convert_metrics(start, h)]
        self._log_epochs(metrics)
        return metrics

    def train_epoch_out_of_core(self, reader, chunk_tokens: int = 1 << 22,
                                seed: int | None = None) -> list[TrainingMetrics]:
        """One epoch over a disk-resident cache as a few fused chunks
        (``trainer.py:1014-1069`` of the JAX package).

        The epoch's global order is ``default_rng(seed + epoch).permutation``
        of the rows; each slice of ``chunk_tokens`` of it (a multiple of the
        batch) is gathered in sorted order through ``reader.gather``,
        staged in bf16 under AMP, and trained as one
        ``train_epoch_fused(chunk, shuffle=True)`` with the epoch number
        held, so the resample is checked at every chunk boundary.  One
        worker thread gathers chunk i+1 while chunk i trains."""
        from concurrent.futures import ThreadPoolExecutor

        n = reader.num_rows
        b = self.config.batch_size
        chunk_tokens = max(b, (chunk_tokens // b) * b)
        stage_bf16 = self.compute_dtype == torch.bfloat16
        rng = np.random.default_rng((self.config.seed if seed is None else seed) + self.epoch)
        order = rng.permutation(n)

        def fetch(start):
            chunk = reader.gather(np.sort(order[start:start + chunk_tokens]))
            return _tree(lambda a: a.to(torch.bfloat16), chunk) if stage_bf16 else chunk

        epoch_no = self.epoch
        starts = list(range(0, n, chunk_tokens))
        epoch_metrics: list[TrainingMetrics] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(fetch, starts[0])
            for i in range(len(starts)):
                chunk = fut.result()
                if i + 1 < len(starts):
                    fut = ex.submit(fetch, starts[i + 1])
                epoch_metrics.extend(self.train_epoch_fused(chunk, shuffle=True))
                self.epoch = epoch_no  # train_epoch_fused counts an epoch per call
        self.epoch = epoch_no + 1
        return epoch_metrics

    def train_epoch(self, dataloader) -> list[TrainingMetrics]:
        """One epoch, one ``train_step`` per batch of ``dataloader``."""
        epoch_metrics = []
        for batch in dataloader:
            m = self.train_step(batch)
            epoch_metrics.append(m)
            self.metrics_history.append(m)
            if self.wandb_run is not None and self.global_step % 100 == 0:
                self._log_wandb(m)
        self.epoch += 1
        return epoch_metrics

    def train(self, dataloader, epochs: int | None = None, checkpoint_every: int | None = None,
              fused: bool | None = None) -> None:
        """Full loop.  ``fused=None`` takes the fused epoch when the loader
        exposes its rows (``.data``); a fused loader that also has a
        ``reader`` (the launcher's paired reader), or any loader with one
        when ``fused=True``, runs chunked out-of-core epochs,
        ``chunk_tokens`` from the loader or 3 GB of the reader's
        ``row_bytes``
        (``trainer.py:1116-1145`` of the JAX package).  A shard loader
        alone has no ``.data`` and steps batch by batch, as in JAX.
        Resumable: epochs already in ``self.epoch`` are skipped and the
        schedule spans all ``epochs``."""
        epochs = epochs or self.config.epochs
        checkpoint_every = checkpoint_every or self.config.checkpoint_every
        self.setup_scheduler(len(dataloader) * epochs)
        if fused is None:
            fused = hasattr(dataloader, "data")
        streamed = hasattr(dataloader, "reader") and fused is not False
        chunk_tokens = None
        if streamed:
            chunk_tokens = getattr(dataloader, "chunk_tokens", None)
            if chunk_tokens is None:
                chunk_tokens = max(self.config.batch_size,
                                   (3 << 30) // dataloader.reader.row_bytes)
        if fused and not streamed:
            self._train_fused_groups(_tree(self._to_device, dataloader.data), epochs,
                                     checkpoint_every, getattr(dataloader, "shuffle", True))
            self.save_checkpoint("final.npz")
            return
        for ep in range(self.epoch, epochs):
            t0 = time.perf_counter()
            if streamed:
                epoch_metrics = self.train_epoch_out_of_core(dataloader.reader,
                                                             chunk_tokens=chunk_tokens)
            else:
                epoch_metrics = self.train_epoch(dataloader)
            rows = getattr(dataloader, "num_tokens", 0) or self.config.batch_size * len(epoch_metrics)
            self._print_epoch(ep, epoch_metrics, rows / (time.perf_counter() - t0))
            if (ep + 1) % checkpoint_every == 0:
                self.save_checkpoint(f"checkpoint_epoch{ep + 1}.npz")
        self.save_checkpoint("final.npz")

    def _train_fused_groups(self, data, epochs: int, checkpoint_every: int, shuffle: bool) -> None:
        """``train()``'s fused epochs, chained up to each checkpoint boundary
        (``trainer.py:1147-1180`` of the JAX package): one
        :meth:`train_epochs_fused` call and one rate a group (the host
        clock around the call, which ends in the metrics' fetch), one
        printed line an epoch."""
        n_rows = (data[0] if isinstance(data, tuple) else data).shape[0]
        ep = self.epoch
        while ep < epochs:
            group = min(checkpoint_every - ep % checkpoint_every, epochs - ep)
            t0 = time.perf_counter()
            group_metrics = self.train_epochs_fused(data, epochs=group, shuffle=shuffle)
            rate = n_rows * group / (time.perf_counter() - t0)
            per_epoch = max(len(group_metrics) // group, 1)
            for g in range(group):
                self._print_epoch(ep + g, group_metrics[g * per_epoch:(g + 1) * per_epoch], rate)
            ep += group
            if ep % checkpoint_every == 0:
                self.save_checkpoint(f"checkpoint_epoch{ep}.npz")

    def _print_epoch(self, ep: int, epoch_metrics: list[TrainingMetrics], rate: float) -> None:
        """One line an epoch; ``rate``: rows a second over the whole mesh."""
        if not self.is_primary:
            return
        count = max(len(epoch_metrics), 1)
        avg_loss = sum(m.loss for m in epoch_metrics) / count
        avg_l0 = sum(m.l0 for m in epoch_metrics) / count
        dead = epoch_metrics[-1].dead_feature_ratio if epoch_metrics else 0.0
        print(
            f"Epoch {ep + 1}: loss={avg_loss:.4f}, L0={avg_l0:.1f}, dead={dead:.1%}, "
            f"{rate / (self.mesh.size if self.mesh is not None else 1):,.0f} act/s/card",
            flush=True,
        )

    # ------------------------------------------------------------------
    # checkpoints and metrics
    # ------------------------------------------------------------------

    def _checkpoint_tree(self) -> dict:
        """The single-device checkpoint's tree (gathered whole under a
        mesh)."""
        params, opt, dstate = self._gathered()
        return {
            "params": params,
            "opt_state": {"mu": opt.mu, "nu": opt.nu, "count": np.int64(opt.count)},
            "dead_state": dstate,
        }

    def _barrier(self) -> None:
        """Under a mesh: every rank waits for rank 0's file writes."""
        if self.mesh is not None:
            dist.barrier(group=self.mesh.cpu_group)

    def _log_wandb(self, m: TrainingMetrics) -> None:
        self.wandb_run.log(
            {
                "train/loss": m.loss,
                "train/reconstruction_loss": m.reconstruction_loss,
                "train/l0": m.l0,
                "train/dead_ratio": m.dead_feature_ratio,
                "train/lr": m.learning_rate,
            },
            step=m.step,
        )

    def save_checkpoint(self, filename: str) -> Path:
        """Parameters, AdamW state, dead-feature state, schedule position and
        counters in one ``.npz``; also rewrites ``metrics.json``."""
        meta = {
            "global_step": self.global_step,
            "epoch": self.epoch,
            "total_steps": self._total_steps,
            "config": json.loads(self.config.model_dump_json()),
            "resample_rng_state": self._resample_rng.bit_generator.state,
            "num_resampled_total": self.num_resampled_total,
        }
        tree = self._checkpoint_tree()
        out = self.run_dir / filename
        if self.is_primary:
            save_pytree(out, tree, meta=meta)
        self.save_metrics()
        return out

    def load_checkpoint(self, path: str | Path) -> None:
        """Restore a checkpoint (written on one card or by a mesh's rank 0;
        under a mesh every rank reads it whole and takes its blocks at the
        next step)."""
        tree, meta = load_pytree(path)
        dev = self.device
        opt = tree["opt_state"]
        self.opt_state = AdamWState(
            {k: torch.from_numpy(v).to(dev) for k, v in opt["mu"].items()},
            {k: torch.from_numpy(v).to(dev) for k, v in opt["nu"].items()},
            int(opt["count"]),
        )
        ds = tree["dead_state"]
        dstate = DeadFeatureState(
            torch.from_numpy(ds["feature_last_activated"]).to(dev),
            torch.from_numpy(np.asarray(ds["step_count"])).to(dev),
        )
        if self._mesh_placed and self._is_tp():  # the model holds blocks: give it whole tensors
            self._assign({k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                          for k, v in tree["params"].items()}, dstate)
        else:
            self.model.load_params(tree["params"])
            self._dead_state = dstate
        self._mesh_placed = False
        if meta:
            self.global_step = int(meta["global_step"])
            self.epoch = int(meta["epoch"])
            if meta.get("total_steps"):
                self.setup_scheduler(int(meta["total_steps"]))
            if meta.get("resample_rng_state"):
                self._resample_rng.bit_generator.state = meta["resample_rng_state"]
            if "num_resampled_total" in meta:
                self.num_resampled_total = int(meta["num_resampled_total"])
        self._restore_metrics_history()

    def _restore_metrics_history(self) -> None:
        """Reload the metrics written with the checkpoint, dropping steps
        past the restored ``global_step``."""
        path = self.run_dir / "metrics.json"
        if not path.exists():
            return
        try:
            dicts = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return
        self.metrics_history = [
            TrainingMetrics(**d) for d in dicts if int(d.get("step", 0)) <= self.global_step
        ]

    def save_final(self, filename_stem: str = "sae_final") -> None:
        """``sae_final.npz`` (the JAX package's keys) and ``sae_final.pt``
        (the reference torch ``state_dict``); under a mesh the full model,
        written by rank 0."""
        params, _, dstate = self._gathered()
        if self.is_primary:
            save_pytree(self.run_dir / f"{filename_stem}.npz", params)
            export_torch_state_dict(params, state=dstate if hasattr(self.model, "state") else None,
                                    path=self.run_dir / f"{filename_stem}.pt")
        self._barrier()

    def save_metrics(self, filename: str = "metrics.json") -> Path:
        """``metrics.json``: one dict per step with the reference's keys
        (under a mesh, written by rank 0; the others wait for it)."""
        path = self.run_dir / filename
        if not self.is_primary:
            self._barrier()
            return path
        dicts = [
            {
                "step": m.step,
                "loss": m.loss,
                "reconstruction_loss": m.reconstruction_loss,
                "sparsity_loss": m.sparsity_loss,
                "l0": m.l0,
                "dead_feature_ratio": m.dead_feature_ratio,
                "learning_rate": m.learning_rate,
            }
            for m in self.metrics_history
        ]
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(dicts, indent=2))
        os.replace(tmp, path)
        self._barrier()
        return path
