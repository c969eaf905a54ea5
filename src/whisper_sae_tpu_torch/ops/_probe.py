"""What the card probes (``gemm_probe``, ``sae_probe``, ``coder_probe``)
share: a call's time between CUDA events and the card's name and power
limit."""

from __future__ import annotations

import subprocess

import torch


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``iters`` calls of ``fn`` between CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no card listed"
