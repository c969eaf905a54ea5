"""PyTorch/CUDA port of whisper_sae_tpu for one NVIDIA H100.

It extracts Whisper activations into the JAX package's feature-cache
format (log-mel, encoder and decoder capture), trains every coder family
from such a cache (TopK and ReLU SAEs, transcoders, crosscoders) at every
width the JAX package trains (a TopK SAE from whisper-tiny 8x to
whisper-large 64x), transcribes audio by KV-cached greedy decoding,
captures and probes activations (the hooks facades, the logit lens,
cross-attention maps), and runs the research loop on trained SAEs:
feature analysis (top-activating examples, co-activation, clips,
dashboards, auto-labels) and causal interventions (patched forwards,
substitution and ablation effects).  Its launcher (``launch.py``) runs
the ``extract``, ``train`` (``--all-layers``, ``--supervise``),
``train-transcoder``, ``train-crosscoder``, ``analyze``,
``causal-validate`` and ``transcribe`` jobs.  The Pallas kernels on
those paths are hand-written CUDA kernels for sm_90a under
``ops/csrc/``, built with nvcc at first use.  The package imports torch
and numpy (and pydantic/yaml for its config), never jax and nothing of
``whisper_sae_tpu``.
"""

__version__ = "0.1.0"

from .config import (
    DataConfig,
    ExperimentConfig,
    LayerConfig,
    MeshConfig,
    SAEConfig,
    TrainingConfig,
    WandbConfig,
    WhisperConfig,
)

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "LayerConfig",
    "MeshConfig",
    "SAEConfig",
    "TrainingConfig",
    "WandbConfig",
    "WhisperConfig",
    "__version__",
]
