"""Activation-capture facades (counterpart of ``whisper_sae_tpu/models/hooks.py``).

The names, call patterns and result layout of a hook-based extractor
(``ActivationCache``, ``WhisperActivationExtractor``,
``extract_features_batch``) over the functional capture: one
``extract_activations`` call a batch returns every layer, and the
requested layers are copied to the host as numpy arrays.  There are no
hooks to register or remove; the calls that would do so are kept and do
nothing.  With ``compute_dtype=torch.bfloat16`` the capture takes the
fused encoder kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .whisper import WhisperArch, extract_activations


@dataclass
class ActivationCache:
    """Host-side cache of captured activations: per-layer lists of
    per-batch numpy arrays; ``get_*_activations`` concatenates them along
    the batch axis, or returns None for a layer never captured."""

    encoder: dict[int, list[np.ndarray]] = field(default_factory=dict)
    decoder: dict[int, list[np.ndarray]] = field(default_factory=dict)

    def clear(self) -> None:
        self.encoder.clear()
        self.decoder.clear()

    def get_encoder_activations(self, layer: int) -> np.ndarray | None:
        """``[sum(B), T, D]`` of one encoder layer."""
        if not self.encoder.get(layer):
            return None
        return np.concatenate(self.encoder[layer], axis=0)

    def get_decoder_activations(self, layer: int) -> np.ndarray | None:
        """``[sum(B), 1, D]`` of one decoder layer."""
        if not self.decoder.get(layer):
            return None
        return np.concatenate(self.decoder[layer], axis=0)


class WhisperActivationExtractor:
    """Capture per-layer Whisper activations::

        extractor = WhisperActivationExtractor(params, arch, encoder_layers=[2, 5])
        with extractor:
            extractor.capture(mel)
        acts = extractor.cache.get_encoder_activations(2)

    ``apply_layer_norm`` applies the stack's final LayerNorm to every
    captured layer.  The decoder runs only when decoder layers are asked
    for."""

    def __init__(self, params: dict, arch: WhisperArch,
                 encoder_layers: Sequence[int] | None = None,
                 decoder_layers: Sequence[int] | None = None,
                 apply_layer_norm: bool = True, compute_dtype: torch.dtype | None = None):
        self.params = params
        self.arch = arch
        self.encoder_layers = list(encoder_layers or [])
        self.decoder_layers = list(decoder_layers or [])
        self.apply_layer_norm = apply_layer_norm
        self.compute_dtype = compute_dtype
        self.cache = ActivationCache()

    def capture(self, mel) -> None:
        """Run the model on one mel batch ``[B, n_mels, T]`` (a tensor, or
        an array moved to the parameters' device) and append the requested
        layers to the cache."""
        if not isinstance(mel, torch.Tensor):
            mel = torch.as_tensor(np.asarray(mel), device=self.params["encoder"]["conv1_w"].device)
        out = extract_activations(self.params, mel, self.arch,
                                  apply_layer_norm=self.apply_layer_norm,
                                  with_decoder=bool(self.decoder_layers),
                                  compute_dtype=self.compute_dtype)
        for idx in self.encoder_layers:
            self.cache.encoder.setdefault(idx, []).append(out["encoder"][idx].cpu().numpy())
        for idx in self.decoder_layers:
            self.cache.decoder.setdefault(idx, []).append(out["decoder"][idx].cpu().numpy())

    def register_hooks(self) -> None:
        """Nothing to register: the capture is functional."""

    def remove_hooks(self) -> None:
        """Nothing to remove."""

    def clear_cache(self) -> None:
        self.cache.clear()

    def __enter__(self) -> "WhisperActivationExtractor":
        return self

    def __exit__(self, *args) -> None:
        return None


def extract_features_batch(params: dict, arch: WhisperArch, input_features,
                           encoder_layers: Sequence[int], decoder_layers: Sequence[int] = (),
                           apply_layer_norm: bool = True,
                           compute_dtype: torch.dtype | None = None
                           ) -> dict[str, dict[int, np.ndarray]]:
    """One-shot capture of one batch: ``{"encoder": {layer: array},
    "decoder": {layer: array}}``, the decoder run on the start token."""
    extractor = WhisperActivationExtractor(params, arch, encoder_layers=encoder_layers,
                                           decoder_layers=decoder_layers,
                                           apply_layer_norm=apply_layer_norm,
                                           compute_dtype=compute_dtype)
    with extractor:
        extractor.capture(input_features)
    results: dict[str, dict[int, np.ndarray]] = {"encoder": {}, "decoder": {}}
    for idx in encoder_layers:
        acts = extractor.cache.get_encoder_activations(idx)
        if acts is not None:
            results["encoder"][idx] = acts
    for idx in decoder_layers:
        acts = extractor.cache.get_decoder_activations(idx)
        if acts is not None:
            results["decoder"][idx] = acts
    return results
