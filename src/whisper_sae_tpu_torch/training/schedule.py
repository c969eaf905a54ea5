"""Learning-rate schedules (counterpart of
``whisper_sae_tpu/training/schedule.py``), evaluated in numpy float32 as
the JAX package evaluates them on the host.

Warmup -> cosine, as the reference's ``SequentialLR(LinearLR(0.01 -> 1
over W), CosineAnnealingLR(T_max=total-W, eta_min=0.1*lr))`` with
``W = min(warmup_steps, total_steps // 10)``.  ``count`` is the number of
optimizer updates already applied, so update ``t`` uses ``lr(t)``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int) -> Callable:
    w = min(warmup_steps, total_steps // 10)
    t_cos = max(total_steps - w, 1)
    eta_min = 0.1 * base_lr

    def schedule(count):
        t = np.asarray(count, np.float32)
        if w > 0:
            warm = base_lr * (0.01 + 0.99 * np.minimum(t, w) / w)
        else:
            warm = base_lr * np.ones_like(t)
        c = np.clip(t - w, 0.0, t_cos)
        cos = eta_min + (base_lr - eta_min) * 0.5 * (1.0 + np.cos(np.pi * c / t_cos))
        return np.where(t < w, warm, cos)

    return schedule


def constant_schedule(base_lr: float) -> Callable:
    """The rate before a schedule is installed: the base rate."""

    def schedule(count):
        return np.full(np.shape(count), base_lr, np.float32)[()]

    return schedule
