"""Data pipeline: mel frontend, synthetic speech and audio loaders,
activation loaders and the sharded feature cache (counterpart of
``whisper_sae_tpu/data``; LibriSpeech streaming needs the network and is
not ported)."""

from .feature_cache import CacheMetadata, FeatureCache, extract_and_cache_features
from .librispeech import AudioBatchLoader, LibriSpeechFeaturesOnly, SyntheticSpeechDataset
from .loader import ActivationLoader, MultiLayerLoader, PairedActivationLoader
from .mel import log_mel_spectrogram, mel_filter_bank

__all__ = [
    "ActivationLoader",
    "AudioBatchLoader",
    "MultiLayerLoader",
    "PairedActivationLoader",
    "CacheMetadata",
    "FeatureCache",
    "LibriSpeechFeaturesOnly",
    "SyntheticSpeechDataset",
    "extract_and_cache_features",
    "log_mel_spectrogram",
    "mel_filter_bank",
]
