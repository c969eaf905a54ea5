"""Trainers for transcoders and crosscoders (counterpart of
``whisper_sae_tpu/training/coder_trainers.py``).

Both reuse :class:`SAETrainer` whole (step, fused epochs, schedule,
checkpoints, metrics, resampling) and override its family hooks.  Under
AMP, wherever the JAX package fuses the family (``coder_supported``, with
the skip path counted), the fused epoch reads each batch at a row offset
into the epoch buffers through the kernel's windowed entries; otherwise
each step takes a slice view of the buffers (a transcoder past the 48 MiB
budget: the top-k encode, then the composed decode;
``coder_trainers.py:72-85`` of the JAX package).  On a mesh whose
``model`` axis is above 1 both take their dp x tp family
(``parallel/tp_step.py``); on a pure-data mesh each rank's dp step runs
the coder kernel on its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.crosscoder import crosscoder_loss, decoder_norms
from ..models.transcoder import transcoder_loss
from ..ops.cuda_coder import (coder_supported, fused_relu_crosscoder_loss_indexed,
                              fused_transcoder_loss_indexed)
from .trainer import SAETrainer, _zero_aux


class TranscoderTrainer(SAETrainer):
    """Trains TopK / Skip transcoders on (mlp_input, mlp_output) pairs.

    Batches are ``(x, y)`` tuples or stacked ``[2, B, D]`` arrays; the
    epoch buffers and ``set_resample_dataset`` take the same pair."""

    @property
    def _use_skip(self) -> bool:
        return "w_skip" in self.model.params

    def _supports_tp(self) -> bool:
        # the hidden dim splits over ``model`` with the distributed
        # bisection top-k, the skip path replicated
        return True

    def _tp_family(self):
        from ..parallel.tp_step import transcoder_family

        return transcoder_family(self.model.k, use_skip=self._use_skip)

    def _prepare_batch(self, batch):
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            return self._to_device(batch[0]), self._to_device(batch[1])
        if getattr(batch, "ndim", 0) == 3 and batch.shape[0] == 2:
            return self._to_device(batch[0]), self._to_device(batch[1])
        raise ValueError("transcoder batches must be (mlp_input, mlp_output)")

    def _loss_fn(self, params, batch):
        x, y = batch
        loss, aux = transcoder_loss(params, x, y, self.model.k, self.compute_dtype,
                                    use_skip=self._use_skip)
        return loss, _zero_aux(loss, {"l0": aux["l0"], "active": aux["active"]})

    def _use_indexed_epoch(self) -> bool:
        m = self.model
        return (self.compute_dtype == torch.bfloat16
                and coder_supported(m.input_dim, m.output_dim, m.hidden_dim,
                                    with_skip=self._use_skip))

    def _indexed_loss_fn(self, params, sel, step: int):
        x, y = sel
        p = params
        loss, l0, active = fused_transcoder_loss_indexed(
            x, y, step, p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"], p.get("w_skip"),
            p.get("b_skip"), self.model.k, self._local_batch, self._use_skip)
        return loss, _zero_aux(loss, {"l0": l0, "active": active})

    def set_resample_dataset(self, dataset) -> None:
        x, y = dataset
        keep = (lambda a: a) if isinstance(x, torch.Tensor) else np.asarray
        self._resample_dataset = (keep(x), keep(y))

    def _resample_from_dataset(self) -> int:
        """Paired (x, y) draw; the bookkeeping stays in the base class."""
        x, y = self._resample_dataset
        n = min(self.resample_batch_size, len(x))
        idx = self._resample_rng.permutation(len(x))[:n]
        if isinstance(x, torch.Tensor):
            idx = torch.from_numpy(idx)
        return self.model.resample_dead_features(x[idx], y[idx])


class CrosscoderTrainer(SAETrainer):
    """Trains cross-layer crosscoders on token-major ``[N, L, D]`` data."""

    def _supports_tp(self) -> bool:
        # TopK crosscoders take the flattened-transcoder family (S split
        # over ``model``); the ReLU variant has its own (no threshold)
        return True

    def _tp_family(self):
        from ..parallel.tp_step import crosscoder_family, relu_crosscoder_family

        if self.model._k is None:
            return relu_crosscoder_family(self.model.sparsity_weight)
        return crosscoder_family(self.model._k)

    def _prepare_batch(self, batch):
        if isinstance(batch, (tuple, list)):
            batch = batch[0]
        if getattr(batch, "ndim", 0) != 3:
            raise ValueError("crosscoder batches must be [B, n_layers, d_model]")
        return self._to_device(batch)

    def _loss_fn(self, params, batch):
        acts = batch.transpose(0, 1)  # [L, B, D], a view
        return crosscoder_loss(params, acts, k=self.model._k,
                               sparsity_weight=self.model.sparsity_weight,
                               compute_dtype=self.compute_dtype)

    def _use_indexed_epoch(self) -> bool:
        width = self.model.n_layers * self.model.d_model
        return (self.compute_dtype == torch.bfloat16
                and coder_supported(width, width, self.model.d_sae))

    def _indexed_prepare(self, sel):
        # [N, L, D] -> the kernel's flattened [N, L*D] view (no copy)
        return sel.reshape(sel.shape[0], -1)

    def _indexed_loss_fn(self, params, sel, step: int):
        k = self.model._k
        n_layers, b = self.model.n_layers, self._local_batch
        s = self.model.d_sae
        p = params
        w_enc, w_dec = p["w_enc"].reshape(-1, s), p["w_dec"].reshape(s, -1)
        b_dec = p["b_dec"].reshape(-1)
        if k is not None:
            flat_loss, l0, active = fused_transcoder_loss_indexed(
                sel, None, step, w_enc, p["b_enc"], w_dec, b_dec, None, None, k, b, False,
                y_is_x=True)
            recon = n_layers * flat_loss  # sum of per-layer means
            return recon, _zero_aux(recon, {"l0": l0, "active": active})
        loss, recon, sparsity, l0, active = fused_relu_crosscoder_loss_indexed(
            sel, step, w_enc, p["b_enc"], w_dec, b_dec, decoder_norms(p),
            float(self.model.sparsity_weight), n_layers, b)
        return loss, {"reconstruction_loss": recon, "sparsity_loss": sparsity, "l0": l0,
                      "active": active}
