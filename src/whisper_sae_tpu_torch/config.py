"""Configuration: pydantic models with YAML round-trip.

The port's own copy of ``whisper_sae_tpu/config.py:31-178``: the same
sections, fields, defaults and validation ranges, so the same YAML files
(e.g. ``configs/tiny_default.yaml``) load unchanged in either package.
``MeshConfig`` and ``TrainingConfig.matmul_precision`` are parsed for
schema compatibility; the port's trainer runs on one card and keeps its
f32 products in true f32 whatever ``matmul_precision`` says.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal

import yaml
from pydantic import BaseModel, Field, model_validator

# d_model, encoder layers, decoder layers per public Whisper checkpoint.
_WHISPER_DIMS: dict[str, tuple[int, int, int]] = {
    "openai/whisper-tiny": (384, 4, 4),
    "openai/whisper-base": (512, 6, 6),
    "openai/whisper-small": (768, 12, 12),
    "openai/whisper-medium": (1024, 24, 24),
    "openai/whisper-large": (1280, 32, 32),
    "openai/whisper-large-v2": (1280, 32, 32),
    "openai/whisper-large-v3": (1280, 32, 32),
}


class WhisperConfig(BaseModel):
    """Subject-model configuration (reference config.py:10-39)."""

    model_name: str = Field(
        default="openai/whisper-tiny",
        description="HuggingFace model name for Whisper",
    )
    hidden_dim: int = Field(default=384, description="Hidden dimension of the model")
    num_encoder_layers: int = Field(default=4, description="Number of encoder layers")
    num_decoder_layers: int = Field(default=4, description="Number of decoder layers")

    @model_validator(mode="after")
    def set_model_dimensions(self) -> "WhisperConfig":
        if self.model_name in _WHISPER_DIMS:
            hidden, enc, dec = _WHISPER_DIMS[self.model_name]
            self.hidden_dim = hidden
            self.num_encoder_layers = enc
            self.num_decoder_layers = dec
        return self


class SAEConfig(BaseModel):
    """Sparse-autoencoder configuration (reference config.py:42-75)."""

    expansion_factor: int = Field(default=8, ge=4, le=32)
    activation: Literal["topk", "relu", "gelu"] = Field(default="topk")
    k: int = Field(default=32, ge=1)
    normalize_decoder: bool = Field(default=True)
    dead_feature_threshold: int = Field(default=10_000)
    dead_feature_resample: bool = Field(default=True)

    def get_hidden_dim(self, input_dim: int) -> int:
        return input_dim * self.expansion_factor


class TrainingConfig(BaseModel):
    """Trainer configuration (reference config.py:78-90).

    ``use_amp`` selects bfloat16 compute (no GradScaler: bf16 shares the
    f32 exponent range).
    """

    batch_size: int = Field(default=128, ge=1)
    learning_rate: float = Field(default=1e-4, gt=0)
    weight_decay: float = Field(default=0.0, ge=0)
    epochs: int = Field(default=50, ge=1)
    warmup_steps: int = Field(default=1000, ge=0)
    gradient_clip: float = Field(default=1.0, gt=0)
    use_amp: bool = Field(default=True)
    checkpoint_every: int = Field(default=10)
    seed: int = Field(default=42)
    num_workers: int = Field(default=4, ge=0)
    # Precision of f32 dots in the JAX package (no reference analogue);
    # kept so the same YAML validates.
    matmul_precision: str = Field(default="default", pattern="^(default|high|highest)$")


class DataConfig(BaseModel):
    """Data pipeline configuration (reference config.py:93-101)."""

    dataset_name: str = Field(default="librispeech_asr")
    dataset_subset: str = Field(default="clean")
    dataset_split: str = Field(default="train.100")
    max_samples: int = Field(default=100_000, ge=1)
    cache_dir: Path = Field(default=Path("cache"))
    streaming: bool = Field(default=True)


class WandbConfig(BaseModel):
    """W&B logging configuration (reference config.py:104-112)."""

    enabled: bool = Field(default=True)
    project: str = Field(default="whisper-sae")
    entity: str | None = Field(default=None)
    name: str | None = Field(default=None)
    tags: list[str] = Field(default_factory=list)
    log_every: int = Field(default=100)


class MeshConfig(BaseModel):
    """Device-mesh configuration of the JAX package (no reference analogue);
    parsed for schema compatibility.

    A 2-D logical mesh ``(data, model)``.  ``data`` shards the token batch
    (gradient all-reduce over ICI); ``model`` shards the SAE feature dim for
    tensor parallelism.  ``-1`` for ``data`` means "all remaining devices".
    """

    data: int = Field(default=-1, description="Devices on the data axis (-1 = all remaining)")
    model: int = Field(default=1, ge=1, description="Devices on the model (TP) axis")
    dtype: Literal["bfloat16", "float32"] = Field(
        default="bfloat16", description="Compute dtype inside the train step"
    )


class ExperimentConfig(BaseModel):
    """Top-level experiment configuration (reference config.py:115-156)."""

    whisper: WhisperConfig = Field(default_factory=WhisperConfig)
    sae: SAEConfig = Field(default_factory=SAEConfig)
    training: TrainingConfig = Field(default_factory=TrainingConfig)
    data: DataConfig = Field(default_factory=DataConfig)
    wandb: WandbConfig = Field(default_factory=WandbConfig)
    mesh: MeshConfig = Field(default_factory=MeshConfig)

    encoder_layers: list[int] = Field(default_factory=lambda: [0, 1, 2, 3])
    decoder_layers: list[int] = Field(default_factory=lambda: [0, 1, 2, 3])

    output_dir: Path = Field(default=Path("outputs"))
    experiment_name: str = Field(default="default")

    @classmethod
    def from_yaml(cls, path: str | Path) -> "ExperimentConfig":
        with open(path) as f:
            data = yaml.safe_load(f)
        return cls(**data)

    def to_yaml(self, path: str | Path) -> None:
        data = self.model_dump(mode="json")
        with open(path, "w") as f:
            yaml.dump(data, f, default_flow_style=False)

    def get_run_dir(self) -> Path:
        run_dir = self.output_dir / self.experiment_name
        run_dir.mkdir(parents=True, exist_ok=True)
        return run_dir
