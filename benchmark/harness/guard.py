"""What a run refuses to measure: no card, too few cards, or a process
that has loaded JAX or the JAX package."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

# compared whole with the part of each loaded module's name before the first
# dot: the port's package begins with the JAX package's name and passes
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_sae_tpu")


class RefusedRun(RuntimeError):
    """A run that must print no result."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden_modules() -> None:
    found = forbidden_modules()
    if found:
        raise RefusedRun(f"the process has loaded {', '.join(found)}: the benchmark measures the "
                         "PyTorch port alone")


def require_cards(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RefusedRun("no CUDA device: the benchmark measures on an NVIDIA GPU and has no "
                         "CPU fallback")
    if torch.cuda.device_count() < chips:
        raise RefusedRun(f"the cell asks for {chips} GPUs, {torch.cuda.device_count()} present")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.empty(1, device=device)  # the context and the allocator, before their statistics are read
    return device


def process_start() -> float:
    """``time.perf_counter()`` at the start of this process: from
    ``/proc/self/stat`` (in clock ticks since boot) where Linux has it,
    else the time of the call."""
    now_pc = time.perf_counter()
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = time.clock_gettime(time.CLOCK_BOOTTIME)
    except (OSError, ValueError, IndexError, AttributeError):
        return now_pc
    return now_pc - max(uptime - started, 0.0)
