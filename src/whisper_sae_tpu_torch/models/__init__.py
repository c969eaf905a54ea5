"""Model families: SAEs, transcoders, crosscoders, and Whisper (counterpart
of ``whisper_sae_tpu/models``)."""

from .crosscoder import (
    CrossLayerCrosscoder,
    CrosscoderOutput,
    TopKCrossLayerCrosscoder,
    create_crosscoder,
)
from .hooks import (
    ActivationCache,
    WhisperActivationExtractor,
    extract_features_batch,
)
from .sae import ReLUSAE, SAEOutput, TopKSAE, create_sae
from .transcoder import (
    SkipTranscoder,
    TopKTranscoder,
    TranscoderOutput,
    create_transcoder,
)
from .whisper import (
    WhisperArch,
    arch_for,
    decoder_forward,
    encoder_forward,
    extract_activations,
    flatten_activations,
    from_hf_torch,
    greedy_decode,
    init_whisper,
    load_pretrained,
)

__all__ = [
    "ActivationCache",
    "CrossLayerCrosscoder",
    "CrosscoderOutput",
    "ReLUSAE",
    "SAEOutput",
    "SkipTranscoder",
    "TopKCrossLayerCrosscoder",
    "TopKSAE",
    "TopKTranscoder",
    "TranscoderOutput",
    "WhisperActivationExtractor",
    "WhisperArch",
    "arch_for",
    "create_crosscoder",
    "create_sae",
    "create_transcoder",
    "decoder_forward",
    "encoder_forward",
    "extract_activations",
    "extract_features_batch",
    "flatten_activations",
    "from_hf_torch",
    "greedy_decode",
    "init_whisper",
    "load_pretrained",
]
