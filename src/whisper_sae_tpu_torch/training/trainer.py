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
``_indexed_prepare`` and ``_indexed_loss_fn``.  This class trains the
TopK SAE (kernel A) and the ReLU SAE (the coder kernel in ReLU mode);
``coder_trainers.py`` overrides the hooks for transcoders and
crosscoders.

The fused epoch (``train_epoch_fused``) keeps the epoch buffer (or the
``(x, y)`` pair of buffers) on the device, gathered once by the
permutation; under AMP each step runs the family's kernel at a row
offset into that buffer (the port of ``fused_sae_loss_indexed`` and the
``*_indexed`` coder entries).  Metrics stay on the device and are
fetched once per epoch; the remainder batch goes through ``train_step``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..config import TrainingConfig
from ..models.sae import (
    DeadFeatureState,
    ReLUSAE,
    dead_feature_mask,
    relu_sae_loss,
    topk_sae_loss,
    update_dead_state,
)
from ..ops.cuda_coder import fused_relu_sae_loss_indexed
from ..ops.cuda_sae import fused_sae_loss_indexed
from ..utils.checkpoint import export_torch_state_dict, load_pytree, save_pytree
from ..utils.device import f32_matmuls
from ..utils.profiling import ThroughputMeter
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
    ):
        self.model = model
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
        self.throughput = ThroughputMeter(num_chips=1)
        self.threshold = getattr(model, "dead_feature_threshold", 10_000)
        # dead-feature counters of a model that keeps none of its own
        self._own_dead = None if hasattr(model, "state") else DeadFeatureState(
            torch.zeros(model.hidden_dim, dtype=torch.int32, device=self.device),
            torch.zeros((), dtype=torch.int32, device=self.device))

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

    def _indexed_prepare(self, sel):
        """The gathered epoch buffer(s) in the kernel's layout (the
        crosscoder flattens [N, L, D])."""
        return sel

    def _indexed_loss_fn(self, params, sel, step: int):
        """``_loss_fn`` over rows ``[step*B, (step+1)*B)`` of the epoch
        buffer, read by the family's kernel at a row offset."""
        b = self.config.batch_size
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
    # the step
    # ------------------------------------------------------------------

    def _step(self, loss_call) -> torch.Tensor:
        """One optimizer step, all on the device.  Returns the step's
        ``_METRIC_KEYS`` as one [5] tensor (no host synchronisation)."""
        params = self.model.params
        with f32_matmuls():
            loss, aux = loss_call(params)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            grads = clip_by_global_norm(grads, self.config.gradient_clip)
            lr = float(np.asarray(self._schedule(self.opt_state.count)))
            self.opt_state = adamw_update_(params, grads, self.opt_state, lr, self.config.weight_decay)
            if self._should_renorm():
                self._renorm_params()
            self._dead_state = update_dead_state(self._dead_state, aux["active"])
            dead = dead_feature_mask(self._dead_state, self.threshold).float().mean()
            return torch.stack([loss.detach(), aux["reconstruction_loss"].detach(),
                                aux["sparsity_loss"].detach(), aux["l0"].float(), dead])

    def _window_loss(self, sel, step: int):
        """Loss over rows ``[step*B, (step+1)*B)`` of the epoch buffer:
        the family's kernel at a row offset under AMP, a slice view in f32."""
        if self.compute_dtype == torch.bfloat16:
            return lambda p: self._indexed_loss_fn(p, sel, step)
        b = self.config.batch_size
        rows = _tree(lambda a: a[step * b:(step + 1) * b], sel)
        return lambda p: self._loss_fn(p, rows)

    def train_step(self, batch) -> TrainingMetrics:
        """One optimizer step on one batch."""
        x = self._prepare_batch(batch)
        lr = self.learning_rate_at(self.global_step)
        row = self._step(lambda p: self._loss_fn(p, x))
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
        num = self._resample_from_dataset()
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

    def _epoch_permutation(self, n: int, seed: int | None) -> torch.Tensor:
        base = self.config.seed if seed is None else seed
        mixed = int(np.random.SeedSequence([base, self.epoch]).generate_state(1)[0])
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
            sel = _tree(lambda a: a[perm[:steps * b]] if perm is not None else a[:steps * b], data)
            if self.compute_dtype == torch.bfloat16:  # the windowed kernel's layout
                sel = self._indexed_prepare(sel)
            start_step = self.global_step
            rows = [self._step(self._window_loss(sel, s)) for s in range(steps)]
            self.global_step += steps
            host = torch.stack(rows).cpu().numpy()  # the epoch's one fetch
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

        self.metrics_history.extend(epoch_metrics)
        if self.wandb_run is not None:
            for m in epoch_metrics:
                if m.step % 100 == 0:
                    self._log_wandb(m)
        self.epoch += 1
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
        exposes its rows (``.data``).  Resumable: epochs already in
        ``self.epoch`` are skipped and the schedule spans all ``epochs``."""
        epochs = epochs or self.config.epochs
        checkpoint_every = checkpoint_every or self.config.checkpoint_every
        self.setup_scheduler(len(dataloader) * epochs)
        if fused is None:
            fused = hasattr(dataloader, "data")
        data = _tree(self._to_device, dataloader.data) if fused else None
        for ep in range(self.epoch, epochs):
            self.throughput.start()
            if fused:
                epoch_metrics = self.train_epoch_fused(data, shuffle=getattr(dataloader, "shuffle", True))
            else:
                epoch_metrics = self.train_epoch(dataloader)
            self.throughput.add_tokens(
                getattr(dataloader, "num_tokens", 0) or self.config.batch_size * len(epoch_metrics)
            )
            rate = self.throughput.stop()
            count = max(len(epoch_metrics), 1)
            avg_loss = sum(m.loss for m in epoch_metrics) / count
            avg_l0 = sum(m.l0 for m in epoch_metrics) / count
            dead = epoch_metrics[-1].dead_feature_ratio if epoch_metrics else 0.0
            print(
                f"Epoch {ep + 1}: loss={avg_loss:.4f}, L0={avg_l0:.1f}, dead={dead:.1%}, "
                f"{rate['activations_per_sec_per_chip']:,.0f} act/s/card",
                flush=True,
            )
            if (ep + 1) % checkpoint_every == 0:
                self.save_checkpoint(f"checkpoint_epoch{ep + 1}.npz")
        self.save_checkpoint("final.npz")

    # ------------------------------------------------------------------
    # checkpoints and metrics
    # ------------------------------------------------------------------

    def _checkpoint_tree(self) -> dict:
        return {
            "params": self.model.params,
            "opt_state": {
                "mu": self.opt_state.mu,
                "nu": self.opt_state.nu,
                "count": np.int64(self.opt_state.count),
            },
            "dead_state": self._dead_state,
        }

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
        out = save_pytree(self.run_dir / filename, self._checkpoint_tree(), meta=meta)
        self.save_metrics()
        return out

    def load_checkpoint(self, path: str | Path) -> None:
        tree, meta = load_pytree(path)
        self.model.load_params(tree["params"])
        dev = self.device
        opt = tree["opt_state"]
        self.opt_state = AdamWState(
            {k: torch.from_numpy(v).to(dev) for k, v in opt["mu"].items()},
            {k: torch.from_numpy(v).to(dev) for k, v in opt["nu"].items()},
            int(opt["count"]),
        )
        ds = tree["dead_state"]
        self._dead_state = DeadFeatureState(
            torch.from_numpy(ds["feature_last_activated"]).to(dev),
            torch.from_numpy(np.asarray(ds["step_count"])).to(dev),
        )
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
        (the reference torch ``state_dict``)."""
        save_pytree(self.run_dir / f"{filename_stem}.npz", self.model.params)
        export_torch_state_dict(
            self.model.params, state=getattr(self.model, "state", None),
            path=self.run_dir / f"{filename_stem}.pt",
        )

    def save_metrics(self, filename: str = "metrics.json") -> Path:
        """``metrics.json``: one dict per step with the reference's keys."""
        path = self.run_dir / filename
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
        return path
