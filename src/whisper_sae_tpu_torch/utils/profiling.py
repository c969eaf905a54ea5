"""Throughput meter (counterpart of ``whisper_sae_tpu/utils/profiling.py:45-73``):
activations per second (per card) over training epochs.  The caller stops
it after work that ended in a device synchronisation."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class ThroughputMeter:
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
