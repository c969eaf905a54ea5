"""Profiling and throughput instrumentation (counterpart of
``whisper_sae_tpu/utils/profiling.py``): a ``torch.profiler`` trace
behind a flag, and activations per second (per card) over training
epochs."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(trace_dir: str | Path | None):
    """Record the CPU (and, where there is a card, CUDA) activity of the
    block with ``torch.profiler`` and write it into ``trace_dir`` as a
    Chrome trace, ``trace_<pid>_<ns>.json``; no-op for ``None``.

        with trace("profiles/run1"):
            trainer.train(...)
    """
    if trace_dir is None:
        yield
        return
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = trace_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    print(f"profiler trace written to {path}", flush=True)


@dataclass
class ThroughputMeter:
    """The caller stops it after work that ended in a device
    synchronisation."""

    num_chips: int = 1
    _t0: float | None = None
    _tokens: int = 0
    history: list[dict] = field(default_factory=list)

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._tokens = 0

    def add_tokens(self, n: int) -> None:
        self._tokens += int(n)

    def stop(self) -> dict:
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop() before start()")
        dt = time.perf_counter() - self._t0
        entry = {
            "tokens": self._tokens,
            "seconds": dt,
            "activations_per_sec": self._tokens / dt if dt > 0 else 0.0,
            "activations_per_sec_per_chip": (
                self._tokens / dt / max(self.num_chips, 1) if dt > 0 else 0.0
            ),
        }
        self.history.append(entry)
        self._t0 = None
        return entry
