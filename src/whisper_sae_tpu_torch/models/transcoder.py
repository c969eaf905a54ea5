"""Transcoders: sparse prediction of an MLP's output from its input
(counterpart of ``whisper_sae_tpu/models/transcoder.py``).

Parameters in the JAX package's layout: ``w_enc [D, H]``, ``b_enc [H]``,
``w_dec [H, dout]``, ``b_dec [dout]`` and, for the Skip variant,
``w_skip [D, dout]``, ``b_skip [dout]``.  TopK encode without a
pre-encoder bias; the Skip variant starts with zero decoder and skip
(the model is a constant function until ``set_output_bias``); resampling
points a dead feature's encoder column at the normalised input and its
decoder row at the normalised residual.

Dispatch: a bf16 ``transcoder_loss`` is the coder kernel
(``ops.cuda_coder.fused_transcoder_loss``), which also exposes
``predicted = resid + y`` and the latent, wherever the JAX package fuses
it (``coder_supported``: bf16 W_enc + W_dec + W_skip within 48 MiB, as
``fused_coder_supported`` with the skip path, H <= 40960; the kernel's
wide route past H = 3072); beyond that budget or that width (whisper-large
8x, whisper-tiny 128x) it is the top-k encode
(``ops.cuda_sae.fused_topk_encode`` with b_pre = 0: kernel B within the
JAX package's 48 MiB of bf16 W_enc, else the blocked encode) followed by
f32 products of bf16 operands for the decode and the skip path, as in
JAX ``models/transcoder.py:114-128``; f32 is the composed path (f32
products, kernel C for the mask).  On the CPU each kernel's plain
version runs instead, on the same route.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_coder import coder_supported, fused_transcoder_loss
from ..ops.cuda_sae import fused_topk_encode
from ..ops.topk import topk_mask_dense
from ..utils.checkpoint import load_pytree
from ..utils.device import f32_matmuls, mm_f32, resolve_device
from .sae import DeadFeatureMixin, ParamModule, _uniform, update_dead_state

TOPK_NAMES = ("w_enc", "b_enc", "w_dec", "b_dec")
SKIP_NAMES = TOPK_NAMES + ("w_skip", "b_skip")


class TranscoderOutput(NamedTuple):
    predicted: torch.Tensor
    hidden: torch.Tensor
    loss: torch.Tensor
    reconstruction_loss: torch.Tensor
    sparsity_loss: torch.Tensor
    l0: torch.Tensor


def _encoder(gen: torch.Generator, input_dim: int, hidden_dim: int) -> dict[str, torch.Tensor]:
    bound = float(1.0 / np.sqrt(input_dim))
    return {"w_enc": _uniform(gen, (input_dim, hidden_dim), bound),
            "b_enc": _uniform(gen, (hidden_dim,), bound)}


def init_topk_transcoder(gen: torch.Generator, input_dim: int, output_dim: int,
                         hidden_dim: int) -> dict[str, torch.Tensor]:
    """Torch-default encoder; decoder xavier-uniform -> unit rows -> x0.1;
    zero decoder bias (the JAX package's distributions, not its bits)."""
    enc = _encoder(gen, input_dim, hidden_dim)
    w_dec = _uniform(gen, (hidden_dim, output_dim), float(np.sqrt(6.0 / (hidden_dim + output_dim))))
    w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True) * 0.1
    return {**enc, "w_dec": w_dec, "b_dec": torch.zeros(output_dim)}


def init_skip_transcoder(gen: torch.Generator, input_dim: int, output_dim: int,
                         hidden_dim: int) -> dict[str, torch.Tensor]:
    """Torch-default encoder; zero decoder, decoder bias and skip path."""
    return {**_encoder(gen, input_dim, hidden_dim),
            "w_dec": torch.zeros(hidden_dim, output_dim), "b_dec": torch.zeros(output_dim),
            "w_skip": torch.zeros(input_dim, output_dim), "b_skip": torch.zeros(output_dim)}


def transcoder_loss(params, x: torch.Tensor, y: torch.Tensor, k: int,
                    compute_dtype=torch.float32, use_skip: bool | None = None
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """loss = mean((topk(x @ W_enc + b_enc) @ W_dec + b_dec [+ x @ W_skip +
    b_skip] - y)^2) -> (loss, {l0, active, predicted, hidden})."""
    if use_skip is None:
        use_skip = "w_skip" in params
    d, h = params["w_enc"].shape
    if compute_dtype == torch.bfloat16 and coder_supported(d, y.shape[1], h, with_skip=use_skip):
        loss, l0, active, resid, hid = fused_transcoder_loss(
            x, y, params["w_enc"], params["b_enc"], params["w_dec"], params["b_dec"],
            params.get("w_skip"), params.get("b_skip"), k, use_skip,
        )
        return loss, {"l0": l0, "active": active, "predicted": resid + y.float(),
                      "hidden": hid.float()}
    if compute_dtype == torch.bfloat16:  # past the coder kernel's budget
        hidden = fused_topk_encode(x, params["w_enc"], params["b_enc"],
                                   torch.zeros(d, device=x.device), k)
        pred = mm_f32(hidden, params["w_dec"].bfloat16()) + params["b_dec"]
        if use_skip:
            pred = pred + (mm_f32(x.bfloat16(), params["w_skip"].bfloat16()) + params["b_skip"])
    else:
        x = x.float()
        with f32_matmuls():
            hidden = topk_mask_dense(torch.matmul(x, params["w_enc"]) + params["b_enc"], k)
            pred = torch.matmul(hidden, params["w_dec"]) + params["b_dec"]
            if use_skip:
                pred = pred + (torch.matmul(x, params["w_skip"]) + params["b_skip"])
    pos = hidden > 0
    return torch.mean(torch.square(pred - y)), {
        "l0": pos.sum(dim=-1).float().mean(), "active": pos.any(dim=0),
        "predicted": pred, "hidden": hidden.float(),
    }


def transcoder_apply(params, x: torch.Tensor, y: torch.Tensor, k: int,
                     compute_dtype=torch.float32) -> tuple[TranscoderOutput, torch.Tensor]:
    """Full forward with the dense latent -> (output, active [H] bool)."""
    loss, aux = transcoder_loss(params, x, y, k, compute_dtype)
    out = TranscoderOutput(predicted=aux["predicted"], hidden=aux["hidden"], loss=loss,
                           reconstruction_loss=loss,
                           sparsity_loss=torch.zeros((), device=loss.device), l0=aux["l0"])
    return out, aux["active"]


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-12)


class _TranscoderBase(DeadFeatureMixin, ParamModule):
    """Shared facade of the TopK and Skip transcoders."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int,
        k: int = 32,
        normalize_decoder: bool = True,
        dead_feature_threshold: int = 10_000,
        *,
        seed: int = 0,
        params: dict | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.hidden_dim = hidden_dim
        self.k = k
        self.normalize_decoder = normalize_decoder
        self.dead_feature_threshold = dead_feature_threshold
        if params is None:
            params = self._init(torch.Generator().manual_seed(seed), input_dim, output_dim,
                                hidden_dim)
        self._set_params(params, dev, hidden_dim)

    def encode(self, x) -> torch.Tensor:
        with f32_matmuls():
            pre = torch.matmul(self._rows(x), self.w_enc) + self.b_enc
        return topk_mask_dense(pre, self.k)

    def decode(self, hidden: torch.Tensor) -> torch.Tensor:
        with f32_matmuls():
            return torch.matmul(hidden.float(), self.w_dec) + self.b_dec

    def forward(self, mlp_input, mlp_output) -> TranscoderOutput:
        out, active = transcoder_apply(self.params, self._rows(mlp_input), self._rows(mlp_output),
                                       self.k)
        if self.training:
            with torch.no_grad():
                self.state = update_dead_state(self.state, active)
        return out

    @torch.no_grad()
    def normalize_decoder_weights(self) -> None:
        self.w_dec.copy_(_unit(self.w_dec))

    @torch.no_grad()
    def resample_dead_features(self, mlp_inputs, mlp_outputs, num_resample: int | None = None
                               ) -> int:
        """Dead features toward the highest-error pairs: the encoder column
        becomes the normalised input, the decoder row the normalised
        residual ``y - predicted``, the encoder bias 0 and the counter the
        current step."""
        dead_indices = torch.nonzero(self.get_dead_features()).flatten()
        num_dead = int(dead_indices.numel())
        if num_dead == 0:
            return 0
        if num_resample is not None:
            num_dead = min(num_dead, num_resample)
            dead_indices = dead_indices[:num_dead]
        x, y = self._rows(mlp_inputs), self._rows(mlp_outputs)
        was_training = self.training
        self.train(False)
        out = self(x, y)
        self.train(was_training)
        residuals = y - out.predicted
        top_idx = torch.topk(torch.sum(torch.square(residuals), dim=-1),
                             min(num_dead, x.shape[0])).indices
        inputs_dir, resid_dir = _unit(x[top_idx]), _unit(residuals[top_idx])
        sel = dead_indices[: inputs_dir.shape[0]]
        self.w_enc[:, sel] = inputs_dir.t()
        self.b_enc[sel] = 0.0
        self.w_dec[sel, :] = resid_dir
        self.feature_last_activated[sel] = self.step_count
        return num_dead


class TopKTranscoder(_TranscoderBase):
    """Plain TopK transcoder."""

    param_names = TOPK_NAMES
    _init = staticmethod(init_topk_transcoder)


class SkipTranscoder(_TranscoderBase):
    """Transcoder with an affine skip path, zero-initialised."""

    param_names = SKIP_NAMES
    _init = staticmethod(init_skip_transcoder)

    @torch.no_grad()
    def set_output_bias(self, mean_output) -> None:
        """Decoder bias <- the empirical mean MLP output."""
        self.b_dec.copy_(self._rows(mean_output))

    def skip(self, x) -> torch.Tensor:
        with f32_matmuls():
            return torch.matmul(self._rows(x), self.w_skip) + self.b_skip

    @torch.no_grad()
    def get_skip_contribution(self, mlp_input, mlp_output) -> float:
        """R^2 of the skip path alone."""
        y = self._rows(mlp_output)
        skip_var = torch.mean(torch.square(self.skip(mlp_input) - y))
        total_var = torch.mean(torch.square(y - torch.mean(y, dim=0)))
        return float(1.0 - skip_var / (total_var + 1e-8))


def create_transcoder(input_dim: int, output_dim: int, hidden_dim: int, k: int = 32,
                      use_skip: bool = True, **kwargs) -> _TranscoderBase:
    cls = SkipTranscoder if use_skip else TopKTranscoder
    return cls(input_dim=input_dim, output_dim=output_dim, hidden_dim=hidden_dim, k=k, **kwargs)


def load_trained_transcoder(run_dir, filename_stem: str = "transcoder_final", device=None
                            ) -> _TranscoderBase:
    """Rebuild a trained transcoder from a ``launch train-transcoder`` run
    directory of either package: ``training_config.json`` and
    ``{filename_stem}.npz``."""
    run_dir = Path(run_dir)
    cfg = json.loads((run_dir / "training_config.json").read_text())["transcoder"]
    model = create_transcoder(cfg["input_dim"], cfg["output_dim"], cfg["hidden_dim"], k=cfg["k"],
                              use_skip=cfg["use_skip"], device=device)
    tree, _ = load_pytree(run_dir / f"{filename_stem}.npz")
    model.load_params(tree)
    return model.eval()
