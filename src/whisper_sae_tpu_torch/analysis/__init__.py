"""Analysis layer of the port (counterpart of
``whisper_sae_tpu/analysis``): top-activation tracking, reports,
co-activation, audio clips, lexical auto-labels and the dashboard."""

from .audio_extraction import (
    AudioClipConfig,
    AudioClipExtractor,
    create_indexed_audio_loader,
    create_librispeech_audio_loader,
    create_synthetic_audio_loader,
)
from .auto_label import auto_label_features
from .coactivation import compute_coactivation, save_coactivation
from .dashboard import generate_dashboard
from .feature_viz import (
    FeatureActivation,
    FeatureInterpretation,
    FeatureReport,
    TopKTracker,
    collect_top_activations,
)

__all__ = [
    "AudioClipConfig",
    "auto_label_features",
    "AudioClipExtractor",
    "FeatureActivation",
    "FeatureInterpretation",
    "FeatureReport",
    "TopKTracker",
    "collect_top_activations",
    "compute_coactivation",
    "create_indexed_audio_loader",
    "create_librispeech_audio_loader",
    "generate_dashboard",
    "save_coactivation",
    "create_synthetic_audio_loader",
]
