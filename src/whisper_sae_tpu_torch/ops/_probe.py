"""What the card probes (``gemm_probe``, ``sae_probe``, ``coder_probe``,
``stem_probe``) share: a call's time between CUDA events, each of its
kernels' device time, a training step's wall time and the card's name
and power limit."""

from __future__ import annotations

import subprocess
import time

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


def device_split(fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by its name
    without the arguments, from ``torch.profiler`` over ``calls`` calls
    after a warm one (the profiler now and then misses a C call's first
    kernel: such a kernel reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.split("(", 1)[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def card() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no card listed"


def step_ms(trainer, rows: torch.Tensor, steps: int, epochs: int = 1) -> float:
    """Wall ms a step over ``epochs`` epochs of ``rows`` (``steps`` batches
    each), after a warm epoch; each epoch ends with its one metrics fetch."""
    trainer.train_epoch_fused(rows, shuffle=False)
    t0 = time.perf_counter()
    for _ in range(epochs):
        trainer.train_epoch_fused(rows, shuffle=False)
    return 1e3 * (time.perf_counter() - t0) / (steps * epochs)
