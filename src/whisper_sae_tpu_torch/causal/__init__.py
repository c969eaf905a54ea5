"""Causal intervention tools of the port (counterpart of
``whisper_sae_tpu/causal``): activation patching, SAE substitution,
feature ablation and steering."""

from .patching import (
    decoder_forward_patched,
    encoder_forward_patched,
    feature_ablation_patch,
    feature_ablation_sweep,
    feature_steering_patch,
    greedy_decode_patched_decoder,
    logit_kl,
    patched_logits,
    patched_logits_decoder,
    sae_reconstruction_patch,
    substitution_effect,
    token_agreement,
)

__all__ = [
    "decoder_forward_patched",
    "encoder_forward_patched",
    "feature_ablation_patch",
    "feature_ablation_sweep",
    "feature_steering_patch",
    "greedy_decode_patched_decoder",
    "logit_kl",
    "patched_logits",
    "patched_logits_decoder",
    "sae_reconstruction_patch",
    "substitution_effect",
    "token_agreement",
]
