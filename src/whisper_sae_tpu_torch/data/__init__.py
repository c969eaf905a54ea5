"""Data pipeline: mel frontend, LibriSpeech's mel cache and synthetic
speech, audio loaders, activation loaders and the sharded feature cache
(counterpart of ``whisper_sae_tpu/data``)."""

from .feature_cache import CacheMetadata, FeatureCache, extract_and_cache_features
from .librispeech import (
    AudioBatchLoader,
    LibriSpeechDataset,
    LibriSpeechFeaturesOnly,
    SyntheticSpeechDataset,
    create_librispeech_dataloader,
)
from .loader import ActivationLoader, MultiLayerLoader, PairedActivationLoader
from .mel import log_mel_spectrogram, mel_filter_bank

__all__ = [
    "ActivationLoader",
    "AudioBatchLoader",
    "MultiLayerLoader",
    "PairedActivationLoader",
    "CacheMetadata",
    "FeatureCache",
    "LibriSpeechDataset",
    "LibriSpeechFeaturesOnly",
    "SyntheticSpeechDataset",
    "create_librispeech_dataloader",
    "extract_and_cache_features",
    "log_mel_spectrogram",
    "mel_filter_bank",
]
