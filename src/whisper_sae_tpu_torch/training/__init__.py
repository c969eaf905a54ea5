"""Training: the trainers, schedules and fused epochs (counterpart of
``whisper_sae_tpu/training``)."""

from .coder_trainers import CrosscoderTrainer, TranscoderTrainer
from .schedule import constant_schedule, warmup_cosine_schedule
from .trainer import SAETrainer, TrainingMetrics

__all__ = [
    "CrosscoderTrainer",
    "SAETrainer",
    "TrainingMetrics",
    "TranscoderTrainer",
    "constant_schedule",
    "warmup_cosine_schedule",
]
