"""TopK and ReLU sparse autoencoders (counterpart of
``whisper_sae_tpu/models/sae.py``).

The functional core takes a parameter dict in the JAX package's layout,
so the two packages compare like with like:

    w_enc [D, H]   encode is x @ w_enc
    w_dec [H, D]   decoder rows are feature directions (unit norm)
    b_enc [H], b_dec [D], b_pre [D]

Dispatch follows the geometry, as in the JAX package (``models/sae.py:
229-246``), with the port's kernel limits as gates: a bf16
``topk_sae_loss`` is kernel A (``ops.cuda_sae.fused_sae_loss``) where
``fused_loss_supported`` holds (the JAX package's budget: bf16 W_enc +
W_dec within 48 MiB, H <= 40960; kernel A's wide route above D = 384 or
H = 3072), else (whisper-tiny 128x, whisper-large) the composed
``topk_sae_apply`` -- as ``ops.cuda_sae.composed_sae_loss``, its forward
under one autograd function whose backward is, on the card, the sparse
entry over the selected latents; a bf16 ``topk_hidden_dense`` is
``fused_topk_encode`` (kernel B wherever bf16 W_enc fits the JAX
package's 48 MiB, up to H = 65536 at whisper-tiny's D = 384; else the
blocked encode, as at whisper-large 16x and wider, up to H = 2^20); an
f32 ``topk_hidden_dense`` is an f32 product (TF32 off) followed by
kernel C (``ops.topk.topk_mask_dense``, its CTA-per-row form above H =
3072, up to H = 262,144).  The f32 latent of ``TopKSAE.encode`` and of the
causal patches (``topk_hidden_f32``) takes the route JAX's
``topk_hidden_dense`` takes on each backend: on the card
``fused_topk_encode`` writing f32 where D and H are multiples of 128,
as the TPU's Pallas encode does (bf16 operands, f32 accumulation); on
the CPU the f32 product and the plain mask, as XLA's.  A bf16
``relu_sae_loss`` is the coder kernel in ReLU mode
(``ops.cuda_coder.fused_relu_sae_loss``) where
``coder_supported`` holds (the same 48 MiB budget, at any H up to
40960: the coder kernel holds a row in one CTA's registers), else the
composed ``relu_sae_apply``.  On the CPU each
kernel's plain version runs instead, on the same route
(``topk_hidden_f32`` aside).

:class:`TopKSAE` is the ``nn.Module`` facade with the reference's object
API (encode/decode/forward/dead features/resampling); :class:`ReLUSAE`
the ReLU + L1 one (``w_enc, b_enc, w_dec, b_dec``: no pre-encoder bias,
no dead-feature state of its own).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import SAEConfig
from ..ops.cuda_coder import coder_supported, fused_relu_sae_loss
from ..ops.cuda_sae import (composed_sae_loss, fused_loss_supported, fused_sae_loss,
                            fused_topk_encode)
from ..ops.topk import relu, topk_encode, topk_mask_dense
from ..utils.checkpoint import load_pytree
from ..utils.device import f32_matmuls, mm_f32, resolve_device

PARAM_NAMES = ("w_enc", "b_enc", "w_dec", "b_dec", "b_pre")
RELU_PARAM_NAMES = ("w_enc", "b_enc", "w_dec", "b_dec")


class SAEOutput(NamedTuple):
    """Forward-pass output (the JAX package's ``SAEOutput``)."""

    reconstructed: torch.Tensor
    hidden: torch.Tensor
    loss: torch.Tensor
    reconstruction_loss: torch.Tensor
    sparsity_loss: torch.Tensor
    l0: torch.Tensor


class DeadFeatureState(NamedTuple):
    """Dead-feature counters: last step each feature fired, and steps run."""

    feature_last_activated: torch.Tensor  # [H] int32
    step_count: torch.Tensor  # scalar int32


def init_dead_state(hidden_dim: int, device=None) -> DeadFeatureState:
    """Zeroed counters, on the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    return DeadFeatureState(torch.zeros(hidden_dim, dtype=torch.int32, device=dev),
                            torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)


def init_topk_sae(gen: torch.Generator, input_dim: int, hidden_dim: int) -> dict[str, torch.Tensor]:
    """TopK-SAE init with the JAX package's distributions (not its bits):
    decoder xavier-uniform -> unit rows -> x0.1; encoder weight and bias
    U(-1/sqrt(D), 1/sqrt(D)); zero decoder and pre-encoder biases.  Drawn
    on the CPU from ``gen``, so the values do not depend on the device."""
    w_dec = _uniform(gen, (hidden_dim, input_dim), float(np.sqrt(6.0 / (input_dim + hidden_dim))))
    w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True) * 0.1
    bound = float(1.0 / np.sqrt(input_dim))
    w_enc = _uniform(gen, (input_dim, hidden_dim), bound)
    b_enc = _uniform(gen, (hidden_dim,), bound)
    return {
        "w_enc": w_enc,
        "b_enc": b_enc,
        "w_dec": w_dec,
        "b_dec": torch.zeros(input_dim),
        "b_pre": torch.zeros(input_dim),
    }


def init_relu_sae(gen: torch.Generator, input_dim: int, hidden_dim: int,
                  normalize_decoder: bool = True) -> dict[str, torch.Tensor]:
    """ReLU-SAE init with the JAX package's distributions: torch-default
    (``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``) encoder and decoder, decoder
    rows unit norm when ``normalize_decoder``."""
    enc_bound, dec_bound = float(1.0 / np.sqrt(input_dim)), float(1.0 / np.sqrt(hidden_dim))
    w_dec = _uniform(gen, (hidden_dim, input_dim), dec_bound)
    if normalize_decoder:
        w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True)
    return {
        "w_enc": _uniform(gen, (input_dim, hidden_dim), enc_bound),
        "b_enc": _uniform(gen, (hidden_dim,), enc_bound),
        "w_dec": w_dec,
        "b_dec": _uniform(gen, (input_dim,), dec_bound),
    }


# ---------------------------------------------------------------------------
# functional forward
# ---------------------------------------------------------------------------


def normalize_decoder(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Unit-norm decoder rows (applied after every optimizer step)."""
    w_dec = params["w_dec"]
    norm = torch.linalg.vector_norm(w_dec, dim=1, keepdim=True)
    return {**params, "w_dec": w_dec / torch.clamp(norm, min=1e-12)}


def topk_encode_sparse(params, x: torch.Tensor, k: int, compute_dtype=torch.float32
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode to the compact (vals [B, k], idx [B, k]) form."""
    return topk_encode(x, params["w_enc"], params["b_enc"], params["b_pre"], k, compute_dtype)


def topk_hidden_dense(params, x: torch.Tensor, k: int, compute_dtype=torch.float32) -> torch.Tensor:
    """Dense [B, H] top-k latent.  bf16: kernel B or the blocked encode
    (bf16 encode and latent); f32: an f32 product (TF32 off) and kernel C."""
    if compute_dtype == torch.bfloat16:
        return fused_topk_encode(x, params["w_enc"], params["b_enc"], params["b_pre"], k)
    xc = x - params["b_pre"]
    with f32_matmuls():
        pre = torch.matmul(xc, params["w_enc"]) + params["b_enc"]
    return topk_mask_dense(pre, k)


def topk_hidden_f32(params, x: torch.Tensor, k: int) -> torch.Tensor:
    """f32 [B, H] top-k latent as JAX's ``topk_hidden_dense`` gives it on
    the backend of ``x``: on the card, where D and H are multiples of 128
    (``pallas_sae.supported``), kernel B or the blocked encode writing f32
    (the TPU's ``_encode_forward``, bf16 operands); otherwise the f32
    product and kernel C, or its plain version on the CPU (XLA's route)."""
    d, h = params["w_enc"].shape
    if x.device.type == "cuda" and d % 128 == 0 and h % 128 == 0:
        return fused_topk_encode(x, params["w_enc"], params["b_enc"], params["b_pre"], k,
                                 torch.float32)
    return topk_hidden_dense(params, x, k)


def topk_sae_apply(params, x: torch.Tensor, k: int, compute_dtype=torch.float32
                   ) -> tuple[SAEOutput, torch.Tensor]:
    """Pure TopK-SAE forward -> (output, active [H] bool)."""
    hidden = topk_hidden_dense(params, x, k, compute_dtype)
    if compute_dtype == torch.bfloat16:
        recon = mm_f32(hidden.bfloat16(), params["w_dec"].bfloat16())
    else:
        with f32_matmuls():
            recon = torch.matmul(hidden, params["w_dec"])
    recon = recon + params["b_dec"] + params["b_pre"]
    reconstruction_loss = torch.mean(torch.square(recon - x))
    pos = hidden > 0
    l0 = pos.sum(dim=-1).float().mean()
    out = SAEOutput(
        reconstructed=recon,
        hidden=hidden,
        loss=reconstruction_loss,
        reconstruction_loss=reconstruction_loss,
        sparsity_loss=torch.zeros((), device=x.device),
        l0=l0,
    )
    return out, pos.any(dim=0)


def topk_sae_loss(params, x: torch.Tensor, k: int, compute_dtype=torch.float32
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training loss -> (loss, {l0, active}).  bf16 is kernel A, the whole
    forward in one launch, where it holds the geometry; otherwise (and in
    f32) the composed path: in bf16 ``composed_sae_loss``, the forward of
    :func:`topk_sae_apply` with the backward over the selected latents (the
    dense products on the CPU), in f32 autograd through
    :func:`topk_sae_apply`."""
    if compute_dtype == torch.bfloat16:
        fused = fused_loss_supported(*params["w_enc"].shape)
        loss, l0, active = (fused_sae_loss if fused else composed_sae_loss)(
            x, params["w_enc"], params["b_enc"], params["b_pre"], params["w_dec"],
            params["b_dec"], k,
        )
        return loss, {"l0": l0, "active": active}
    out, active = topk_sae_apply(params, x, k, compute_dtype)
    return out.loss, {"l0": out.l0, "active": active}


def relu_sae_apply(params, x: torch.Tensor, sparsity_weight: float, compute_dtype=torch.float32
                   ) -> tuple[SAEOutput, torch.Tensor]:
    """Pure ReLU-SAE forward -> (output, active [H] bool): loss = mean
    squared error + ``sparsity_weight`` * mean |hidden|."""
    if compute_dtype == torch.bfloat16:
        pre = mm_f32(x.bfloat16(), params["w_enc"].bfloat16()) + params["b_enc"]
        hidden = relu(pre)
        recon = mm_f32(hidden.bfloat16(), params["w_dec"].bfloat16()) + params["b_dec"]
    else:
        with f32_matmuls():
            hidden = relu(torch.matmul(x.float(), params["w_enc"]) + params["b_enc"])
            recon = torch.matmul(hidden, params["w_dec"]) + params["b_dec"]
    reconstruction_loss = torch.mean(torch.square(recon - x))
    sparsity_loss = torch.mean(torch.abs(hidden))
    pos = hidden > 0
    out = SAEOutput(
        reconstructed=recon,
        hidden=hidden,
        loss=reconstruction_loss + sparsity_weight * sparsity_loss,
        reconstruction_loss=reconstruction_loss,
        sparsity_loss=sparsity_loss,
        l0=pos.sum(dim=-1).float().mean(),
    )
    return out, pos.any(dim=0)


def relu_sae_loss(params, x: torch.Tensor, sparsity_weight: float, compute_dtype=torch.float32
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training loss -> (loss, {reconstruction_loss, sparsity_loss, l0,
    active}).  bf16 is the coder kernel in ReLU mode where it holds the
    geometry; otherwise (and in f32) the composed path."""
    d, h = params["w_enc"].shape
    if compute_dtype == torch.bfloat16 and coder_supported(d, d, h):
        loss, recon, sparsity, l0, active = fused_relu_sae_loss(
            x, params["w_enc"], params["b_enc"], params["w_dec"], params["b_dec"],
            float(sparsity_weight),
        )
        return loss, {"reconstruction_loss": recon, "sparsity_loss": sparsity, "l0": l0,
                      "active": active}
    out, active = relu_sae_apply(params, x, sparsity_weight, compute_dtype)
    return out.loss, {"reconstruction_loss": out.reconstruction_loss,
                      "sparsity_loss": out.sparsity_loss, "l0": out.l0, "active": active}


def update_dead_state(state: DeadFeatureState, active: torch.Tensor) -> DeadFeatureState:
    """step_count += 1; features active this step get last_activated = step."""
    step = state.step_count + 1
    return DeadFeatureState(torch.where(active, step, state.feature_last_activated), step)


def dead_feature_mask(state: DeadFeatureState, threshold: int) -> torch.Tensor:
    """Steps since a feature last fired > threshold."""
    return (state.step_count - state.feature_last_activated) > threshold


# ---------------------------------------------------------------------------
# nn.Module facade
# ---------------------------------------------------------------------------


class ParamModule(nn.Module):
    """Parameters named as in the JAX package's dicts, held as
    ``nn.Parameter`` attributes on one device (the card unless the caller
    asks for the CPU), with the dead-feature counters as buffers when the
    family keeps them.  Shared by every SAE, transcoder and crosscoder
    facade."""

    param_names: tuple[str, ...] = ()

    def _set_params(self, params: dict, dev: torch.device, hidden_dim: int | None) -> None:
        for name in self.param_names:
            t = torch.as_tensor(params[name], dtype=torch.float32)
            setattr(self, name, nn.Parameter(t.detach().clone().to(dev)))
        if hidden_dim is not None:
            self.register_buffer("feature_last_activated",
                                 torch.zeros(hidden_dim, dtype=torch.int32, device=dev))
            self.register_buffer("step_count", torch.zeros((), dtype=torch.int32, device=dev))

    @property
    def device(self) -> torch.device:
        return self.w_enc.device

    @property
    def params(self) -> dict[str, nn.Parameter]:
        return {name: getattr(self, name) for name in self.param_names}

    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        """Copy values (tensors or arrays, JAX layout) into the parameters."""
        for name in self.param_names:
            value = params[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            getattr(self, name).copy_(value.to(torch.float32))

    def _rows(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)


class DeadFeatureMixin:
    """Dead-feature counters kept in the ``feature_last_activated`` and
    ``step_count`` buffers (needs ``dead_feature_threshold``)."""

    @property
    def state(self) -> DeadFeatureState:
        return DeadFeatureState(self.feature_last_activated, self.step_count)

    @state.setter
    def state(self, value: DeadFeatureState) -> None:
        self.feature_last_activated.copy_(value.feature_last_activated)
        self.step_count.copy_(value.step_count)

    def get_dead_features(self) -> torch.Tensor:
        return dead_feature_mask(self.state, self.dead_feature_threshold)

    def get_dead_feature_ratio(self) -> float:
        return float(self.get_dead_features().float().mean())


class TopKSAE(DeadFeatureMixin, ParamModule):
    """TopK sparse autoencoder with the reference object API.

    ``device=None`` means the card (raises without one); pass
    ``device="cpu"`` to run the plain versions on the CPU."""

    param_names = PARAM_NAMES

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        k: int = 32,
        normalize_decoder: bool = True,
        dead_feature_threshold: int = 10_000,
        *,
        seed: int = 0,
        params: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.k = k
        self.normalize_decoder = normalize_decoder
        self.dead_feature_threshold = dead_feature_threshold
        if params is None:
            params = init_topk_sae(torch.Generator().manual_seed(seed), input_dim, hidden_dim)
        self._set_params(params, dev, hidden_dim)

    # -- forward API --
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return topk_hidden_f32(self.params, self._rows(x), self.k)

    def encode_sparse(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        """(vals, idx) of the f32 top-k encode, on the model's device."""
        return topk_encode_sparse(self.params, self._rows(x), self.k)

    def decode(self, hidden: torch.Tensor) -> torch.Tensor:
        with f32_matmuls():
            recon = torch.matmul(hidden.float(), self.w_dec) + self.b_dec
        return recon + self.b_pre

    def forward(self, x) -> SAEOutput:
        """f32 forward (kernel C behind the f32 encode product); updates the
        dead-feature counters in training mode."""
        out, active = topk_sae_apply(self.params, self._rows(x), self.k, torch.float32)
        if self.training:
            with torch.no_grad():
                self.state = update_dead_state(self.state, active)
        return out

    # -- decoder norm invariant --
    @torch.no_grad()
    def normalize_decoder_weights(self) -> None:
        self.w_dec.copy_(normalize_decoder(self.params)["w_dec"])

    # -- dead features --
    @torch.no_grad()
    def resample_dead_features(self, inputs, num_resample: int | None = None) -> int:
        """Re-initialise dead features toward the highest-error inputs: the
        encoder column and decoder row both become the normalised input,
        the encoder bias 0, the counter the current step.  Runs off the
        hot path (once per thousands of steps)."""
        dead_indices = torch.nonzero(self.get_dead_features()).flatten()
        num_dead = int(dead_indices.numel())
        if num_dead == 0:
            return 0
        if num_resample is not None:
            num_dead = min(num_dead, num_resample)
            dead_indices = dead_indices[:num_dead]
        rows = torch.as_tensor(inputs).to(self.device)
        if rows.dtype != torch.bfloat16:  # a bf16 cache's rows stay bf16, as in JAX
            rows = rows.float()
        x = rows.float()  # exact: the forward sees the same values
        was_training = self.training
        self.train(False)
        out = self(x)
        self.train(was_training)
        errors = torch.sum(torch.square(x - out.reconstructed), dim=-1)
        n_take = min(num_dead, errors.shape[0])
        top_idx = torch.topk(errors, n_take).indices
        high_err = rows[top_idx]
        # jnp.linalg.norm of bf16 rows as XLA computes it: the squares and
        # their sum in f32, the sum and its root rounded to the rows' dtype
        wide = high_err.float()
        norm = torch.sqrt(torch.sum(wide * wide, dim=-1, keepdim=True).to(high_err.dtype))
        high_err = (high_err / torch.clamp(norm, min=1e-12)).float()
        sel = dead_indices[: high_err.shape[0]]
        self.w_enc[:, sel] = high_err.t()
        self.b_enc[sel] = 0.0
        self.w_dec[sel, :] = high_err
        self.feature_last_activated[sel] = self.step_count
        return num_dead


class ReLUSAE(ParamModule):
    """ReLU + L1 sparse autoencoder (the JAX package's ``ReLUSAE``): no
    pre-encoder bias and no dead-feature state or resampling."""

    param_names = RELU_PARAM_NAMES

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        sparsity_weight: float = 0.01,
        normalize_decoder: bool = True,
        *,
        seed: int = 0,
        params: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.sparsity_weight = sparsity_weight
        self.normalize_decoder = normalize_decoder
        if params is None:
            params = init_relu_sae(torch.Generator().manual_seed(seed), input_dim, hidden_dim,
                                   normalize_decoder)
        self._set_params(params, dev, None)

    def encode(self, x) -> torch.Tensor:
        with f32_matmuls():
            return relu(torch.matmul(self._rows(x), self.w_enc) + self.b_enc)

    def decode(self, hidden: torch.Tensor) -> torch.Tensor:
        with f32_matmuls():
            return torch.matmul(hidden.float(), self.w_dec) + self.b_dec

    def forward(self, x) -> SAEOutput:
        return relu_sae_apply(self.params, self._rows(x), self.sparsity_weight)[0]

    @torch.no_grad()
    def normalize_decoder_weights(self) -> None:
        if self.normalize_decoder:
            self.w_dec.copy_(normalize_decoder(self.params)["w_dec"])


def create_sae(config: SAEConfig, input_dim: int, *, seed: int = 0, device=None
               ) -> TopKSAE | ReLUSAE:
    """Factory: ``activation == "topk"`` -> :class:`TopKSAE`; any other
    activation (``relu``, ``gelu``) -> :class:`ReLUSAE` with its default
    sparsity weight, as in the JAX package."""
    hidden_dim = config.get_hidden_dim(input_dim)
    if config.activation != "topk":
        return ReLUSAE(input_dim=input_dim, hidden_dim=hidden_dim,
                       normalize_decoder=config.normalize_decoder, seed=seed, device=device)
    return TopKSAE(
        input_dim=input_dim,
        hidden_dim=hidden_dim,
        k=config.k,
        normalize_decoder=config.normalize_decoder,
        dead_feature_threshold=config.dead_feature_threshold,
        seed=seed,
        device=device,
    )


def load_trained_sae(run_dir, filename_stem: str = "sae_final", device=None) -> TopKSAE | ReLUSAE:
    """Rebuild a trained SAE from a run directory: the ``SAEConfig`` in
    ``training_config.json`` and the parameters in ``{filename_stem}.npz``
    (written by either package)."""
    run_dir = Path(run_dir)
    cfg = json.loads((run_dir / "training_config.json").read_text())
    tree, _ = load_pytree(run_dir / f"{filename_stem}.npz")
    sae = create_sae(SAEConfig(**cfg["sae"]), input_dim=tree["w_enc"].shape[0], device=device)
    sae.load_params(tree)
    return sae
