"""PyTorch/CUDA port of whisper_sae_tpu for one NVIDIA H100.

It trains TopK SAEs from a cached Whisper layer (feature extraction and
the other coder families are not ported yet).  The Pallas kernels on
that path are hand-written CUDA kernels for sm_90a under ``ops/csrc/``,
built with nvcc at first use.  The package imports torch
and numpy (and pydantic/yaml for its config), never jax and nothing of
``whisper_sae_tpu``.
"""

__version__ = "0.1.0"
