"""Cross-layer crosscoders: features shared across layers (counterpart of
``whisper_sae_tpu/models/crosscoder.py``).

Parameters in the JAX package's layout: per-layer encoders
``w_enc [L, D, S]``, a shared decoder ``w_dec [S, L, D]``, ``b_enc [S]``
and ``b_dec [L, D]``.  The functional core takes activations stacked as
``[L, B, D]``; the encode sums the per-layer contributions, which is one
``[B, L*D] @ [L*D, S]`` product.  The loss is the sum of per-layer MSEs
plus, in the ReLU variant, the decoder-norm-weighted L1.

Dispatch: a bf16 ``crosscoder_loss`` is the coder kernel on the
flattened ``[B, L*D]`` view -- TopK through ``fused_transcoder_loss``
with ``y = x``, ReLU through ``fused_relu_crosscoder_loss`` with the
flat decoder norms as a differentiable input -- wherever the JAX package
fuses it (``coder_supported``: bf16 W_enc + W_dec within 48 MiB, the
kernel's wide route past S = 3072); past that budget and in f32 it is
``crosscoder_apply``: f32 products of bf16 operands, and for the bf16
TopK variant the top-k encode on the flattened view
(``ops.cuda_sae.fused_topk_encode``) where bf16 W_enc alone fits the
budget, as JAX ``models/crosscoder.py:124-144`` encodes, else kernel C
for the mask (its wide form above 3072).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_coder import coder_supported, fused_relu_crosscoder_loss, fused_transcoder_loss
from ..ops.cuda_sae import fused_topk_encode, uses_blocked
from ..ops.topk import relu, topk_mask_dense
from ..utils.checkpoint import load_pytree
from ..utils.device import f32_matmuls, mm_f32, resolve_device
from .sae import DeadFeatureMixin, ParamModule, update_dead_state

PARAM_NAMES = ("w_enc", "b_enc", "w_dec", "b_dec")


class CrosscoderOutput(NamedTuple):
    reconstructed: dict[int, torch.Tensor]
    hidden: torch.Tensor
    loss: torch.Tensor
    reconstruction_loss: torch.Tensor
    sparsity_loss: torch.Tensor
    l0: torch.Tensor
    per_layer_loss: dict[int, torch.Tensor]


def init_crosscoder(gen: torch.Generator, d_model: int, n_layers: int, d_sae: int,
                    normalize_decoder: bool = True) -> dict[str, torch.Tensor]:
    """Xavier-uniform decoder (fan-in L*D) -> flat unit rows -> x0.1, the
    encoder its transpose per layer, zero biases."""
    bound = float(np.sqrt(6.0 / (d_sae + n_layers * d_model)))
    w_dec = torch.empty((d_sae, n_layers, d_model)).uniform_(-bound, bound, generator=gen)
    if normalize_decoder:
        flat = w_dec.reshape(d_sae, -1)
        w_dec = (flat / torch.linalg.vector_norm(flat, dim=1, keepdim=True)).reshape(w_dec.shape) * 0.1
    return {
        "w_enc": w_dec.permute(1, 2, 0).contiguous(),
        "b_enc": torch.zeros(d_sae),
        "w_dec": w_dec,
        "b_dec": torch.zeros(n_layers, d_model),
    }


def _flat(params) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w_enc [L*D, S], w_dec [S, L*D], b_dec [L*D]): views, no copies."""
    s = params["b_enc"].shape[0]
    return (params["w_enc"].reshape(-1, s), params["w_dec"].reshape(s, -1),
            params["b_dec"].reshape(-1))


def _rows_of(acts: torch.Tensor) -> torch.Tensor:
    """[L, B, D] -> [B, L*D] (a view when ``acts`` is the transpose of a
    contiguous [B, L, D] batch)."""
    l, b, d = acts.shape
    return acts.transpose(0, 1).reshape(b, l * d)


def crosscoder_encode_pre(params, acts: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Summed per-layer encoder contributions: [L, B, D] -> pre [B, S]."""
    w_enc = _flat(params)[0]
    x = _rows_of(acts)
    if compute_dtype == torch.bfloat16:
        return mm_f32(x.bfloat16(), w_enc.bfloat16()) + params["b_enc"]
    with f32_matmuls():
        return torch.matmul(x.float(), w_enc) + params["b_enc"]


def crosscoder_decode(params, hidden: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """[B, S] -> per-layer reconstructions [L, B, D]."""
    l, d = params["b_dec"].shape
    w_dec = _flat(params)[1]
    if compute_dtype == torch.bfloat16:
        flat = mm_f32(hidden.bfloat16(), w_dec.bfloat16())
    else:
        with f32_matmuls():
            flat = torch.matmul(hidden.float(), w_dec)
    return flat.reshape(-1, l, d).transpose(0, 1) + params["b_dec"][:, None, :]


def decoder_norms(params) -> torch.Tensor:
    """Per-feature decoder norm over all layers [S]."""
    w = params["w_dec"]
    return torch.linalg.vector_norm(w.reshape(w.shape[0], -1), dim=1)


def _encode_fits(width: int, s: int) -> bool:
    """The flattened TopK encode takes the top-k encode (kernel B): bf16
    W_enc [L*D, S] within the JAX package's budget
    (``pallas_sae.py:uses_blocked`` false), widths multiples of 32."""
    return width % 32 == 0 and s % 32 == 0 and not uses_blocked(width, s)


def crosscoder_apply(params, acts: torch.Tensor, *, k: int | None = None,
                     sparsity_weight: float = 0.01, compute_dtype=torch.float32):
    """Pure forward on [L, B, D] -> (recon [L, B, D], hidden [B, S], loss,
    recon_loss, sparsity_loss, l0).  ``k=None`` is the ReLU + weighted-L1
    variant.  Under AMP the TopK encode is the top-k encode on the
    flattened view (b_pre = 0, a bf16 latent) where bf16 W_enc fits the
    budget, as the JAX package encodes it."""
    n_layers, _, d_model = acts.shape
    width = n_layers * d_model
    if (k is not None and compute_dtype == torch.bfloat16
            and _encode_fits(width, params["b_enc"].shape[0])):
        hidden = fused_topk_encode(_rows_of(acts), _flat(params)[0], params["b_enc"],
                                   torch.zeros(width, device=acts.device), k)
    else:
        pre = crosscoder_encode_pre(params, acts, compute_dtype)
        hidden = relu(pre) if k is None else topk_mask_dense(pre, k)
    recon = crosscoder_decode(params, hidden, compute_dtype)
    recon_loss = torch.mean(torch.square(recon - acts), dim=(1, 2)).sum()
    if k is None:
        with f32_matmuls():
            sparsity = torch.mean(torch.matmul(torch.abs(hidden), decoder_norms(params)))
        loss = recon_loss + sparsity_weight * sparsity
    else:
        sparsity = torch.zeros((), device=acts.device)
        loss = recon_loss
    l0 = (hidden > 0).sum(dim=-1).float().mean()
    return recon, hidden, loss, recon_loss, sparsity, l0


def crosscoder_loss(params, acts: torch.Tensor, *, k: int | None = None,
                    sparsity_weight: float = 0.01, compute_dtype=torch.float32
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training loss -> (loss, {reconstruction_loss, sparsity_loss, l0,
    active}).  bf16 runs the coder kernel on the flattened view, where the
    sum of per-layer means is L x the flat mean, wherever the kernel takes
    the geometry; past its budget it is ``crosscoder_apply``, as the JAX
    package composes it beyond ``fused_coder_supported``."""
    n_layers, _, d_model = acts.shape
    width = n_layers * d_model
    if compute_dtype == torch.bfloat16 and coder_supported(width, width, params["b_enc"].shape[0]):
        x = _rows_of(acts)
        w_enc, w_dec, b_dec = _flat(params)
        if k is not None:
            flat_loss, l0, active, _, _ = fused_transcoder_loss(
                x, None, w_enc, params["b_enc"], w_dec, b_dec, None, None, k, False, y_is_x=True)
            recon = n_layers * flat_loss
            return recon, {"reconstruction_loss": recon,
                           "sparsity_loss": torch.zeros((), device=x.device), "l0": l0,
                           "active": active}
        loss, recon, sparsity, l0, active = fused_relu_crosscoder_loss(
            x, w_enc, params["b_enc"], w_dec, b_dec, decoder_norms(params), sparsity_weight,
            n_layers)
        return loss, {"reconstruction_loss": recon, "sparsity_loss": sparsity, "l0": l0,
                      "active": active}
    _, hidden, loss, recon, sparsity, l0 = crosscoder_apply(
        params, acts, k=k, sparsity_weight=sparsity_weight, compute_dtype=compute_dtype)
    return loss, {"reconstruction_loss": recon, "sparsity_loss": sparsity, "l0": l0,
                  "active": (hidden > 0).any(dim=0)}


def normalize_crosscoder_decoder(params) -> dict[str, torch.Tensor]:
    """Flat unit norm over (L, D) per feature; zero rows stay zero."""
    w = params["w_dec"]
    flat = w.reshape(w.shape[0], -1)
    flat = flat / torch.clamp(torch.linalg.vector_norm(flat, dim=1, keepdim=True), min=1e-12)
    return {**params, "w_dec": flat.reshape(w.shape)}


class CrossLayerCrosscoder(DeadFeatureMixin, ParamModule):
    """ReLU + decoder-norm-weighted-L1 crosscoder (``k=None``)."""

    param_names = PARAM_NAMES
    _k: int | None = None

    def __init__(
        self,
        d_model: int,
        n_layers: int,
        d_sae: int,
        layer_indices: list[int] | None = None,
        activation: str = "relu",
        sparsity_weight: float = 0.01,
        normalize_decoder: bool = True,
        dead_feature_threshold: int = 10_000,
        *,
        seed: int = 0,
        params: dict | None = None,
        device: str | torch.device | None = None,
    ):
        if activation != "relu":
            raise ValueError(f"Unknown activation: {activation}")
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.n_layers = n_layers
        self.d_sae = d_sae
        self.hidden_dim = d_sae
        self.layer_indices = layer_indices or list(range(n_layers))
        self.activation = activation
        self.sparsity_weight = sparsity_weight
        self.normalize_decoder = normalize_decoder
        self.dead_feature_threshold = dead_feature_threshold
        if params is None:
            params = init_crosscoder(torch.Generator().manual_seed(seed), d_model, n_layers, d_sae,
                                     normalize_decoder)
        self._set_params(params, dev, d_sae)

    def _stack(self, layer_activations) -> torch.Tensor:
        """dict[layer -> [B, D]] or a stacked [B, L, D] batch -> [L, B, D]."""
        if isinstance(layer_activations, dict):
            return torch.stack([self._rows(layer_activations[li]) for li in self.layer_indices])
        acts = self._rows(layer_activations)
        if acts.dim() != 3 or acts.shape[1] != self.n_layers:
            raise ValueError(f"expected dict of layers or [B, {self.n_layers}, D] array, "
                             f"got shape {tuple(acts.shape)}")
        return acts.transpose(0, 1)

    @property
    def W_enc(self) -> torch.Tensor:
        return self.w_enc

    @property
    def W_dec(self) -> torch.Tensor:
        return self.w_dec

    def encode(self, layer_activations) -> torch.Tensor:
        pre = crosscoder_encode_pre(self.params, self._stack(layer_activations))
        return relu(pre) if self._k is None else topk_mask_dense(pre, self._k)

    def decode(self, hidden: torch.Tensor) -> dict[int, torch.Tensor]:
        recon = crosscoder_decode(self.params, hidden)
        return {li: recon[i] for i, li in enumerate(self.layer_indices)}

    def forward(self, layer_activations) -> CrosscoderOutput:
        acts = self._stack(layer_activations)
        recon, hidden, loss, recon_loss, sparsity, l0 = crosscoder_apply(
            self.params, acts, k=self._k, sparsity_weight=self.sparsity_weight)
        if self.training:
            with torch.no_grad():
                self.state = update_dead_state(self.state, (hidden > 0).any(dim=0))
        return CrosscoderOutput(
            reconstructed={li: recon[i] for i, li in enumerate(self.layer_indices)},
            hidden=hidden, loss=loss, reconstruction_loss=recon_loss, sparsity_loss=sparsity,
            l0=l0,
            per_layer_loss={li: torch.mean(torch.square(recon[i] - acts[i]))
                            for i, li in enumerate(self.layer_indices)},
        )

    @torch.no_grad()
    def normalize_decoder_weights(self) -> None:
        self.w_dec.copy_(normalize_crosscoder_decoder(self.params)["w_dec"])

    def get_decoder_norms(self) -> torch.Tensor:
        return decoder_norms(self.params)

    def get_feature_layer_norms(self) -> torch.Tensor:
        """[S, L] per-layer decoder norms."""
        return torch.linalg.vector_norm(self.w_dec, dim=2)

    def get_cross_layer_features(self, threshold: float = 0.1) -> torch.Tensor:
        """Features with >= 2 layers above ``threshold`` of their largest
        per-layer norm."""
        norms = self.get_feature_layer_norms()
        rel = norms / (torch.amax(norms, dim=1, keepdim=True) + 1e-8)
        return (rel > threshold).sum(dim=1) >= 2


class TopKCrossLayerCrosscoder(CrossLayerCrosscoder):
    """TopK crosscoder: no sparsity term."""

    def __init__(self, d_model: int, n_layers: int, d_sae: int, k: int = 32,
                 layer_indices: list[int] | None = None, normalize_decoder: bool = True,
                 dead_feature_threshold: int = 10_000, *, seed: int = 0,
                 params: dict | None = None, device: str | torch.device | None = None):
        super().__init__(d_model, n_layers, d_sae, layer_indices, "relu", 0.0, normalize_decoder,
                         dead_feature_threshold, seed=seed, params=params, device=device)
        self.k = k
        self._k = k


def create_crosscoder(d_model: int, n_layers: int, d_sae: int, k: int | None = None,
                      use_topk: bool = True, **kwargs) -> CrossLayerCrosscoder:
    if use_topk:
        return TopKCrossLayerCrosscoder(d_model=d_model, n_layers=n_layers, d_sae=d_sae,
                                        k=k or 32, **kwargs)
    return CrossLayerCrosscoder(d_model=d_model, n_layers=n_layers, d_sae=d_sae, **kwargs)


def load_trained_crosscoder(run_dir, filename_stem: str = "crosscoder_final", device=None
                            ) -> CrossLayerCrosscoder:
    """Rebuild a trained crosscoder from a ``launch train-crosscoder`` run
    directory of either package."""
    run_dir = Path(run_dir)
    cfg = json.loads((run_dir / "training_config.json").read_text())["crosscoder"]
    model = create_crosscoder(cfg["d_model"], cfg["n_layers"], cfg["d_sae"], k=cfg.get("k"),
                              use_topk=cfg.get("use_topk", True),
                              layer_indices=cfg.get("layer_indices"), device=device)
    tree, _ = load_pytree(run_dir / f"{filename_stem}.npz")
    model.load_params(tree)
    return model.eval()
