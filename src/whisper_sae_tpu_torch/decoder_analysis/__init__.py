"""Decoder analysis (counterpart of ``whisper_sae_tpu/decoder_analysis``):
cross-attention alignment probes and the logit lens."""

from .cross_attention import attention_entropy, cross_attention_maps, top_attended_frames
from .logit_lens import lens_agreement, logit_lens

__all__ = [
    "attention_entropy",
    "cross_attention_maps",
    "lens_agreement",
    "logit_lens",
    "top_attended_frames",
]
