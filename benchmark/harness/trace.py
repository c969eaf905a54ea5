"""The traced window and its reduction to the numbers the per-layer
metrics read.

A short steady window runs under ``torch.profiler`` (CPU and CUDA
activities) inside a ``bench.window`` range.  Its Chrome trace is read
back and reduced:

- device operations: kernels, copies and sets on the device's timeline;
- the window: the host interval of ``bench.window``, which ends after a
  device synchronisation, so every operation it launched has finished;
- busy time: the union of the device operations' intervals inside the
  window; idle is the rest of it;
- attribution: a device operation counts toward a span (a
  ``record_function`` range, see ``spans.py``) when the host interval of
  one of that span's calls holds the runtime or driver call that
  launched it, matched by the profiler's correlation id.  Nested spans
  each count it.
"""

from __future__ import annotations

import bisect
import json
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
US = 1e-6


def record(window_fn):
    """Run ``window_fn`` (which ends in a device synchronisation) under the
    profiler -> (its result, :class:`Trace`)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            result = window_fn()
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return result, Trace(events)


class Trace:
    """The reduction of one traced window (times in seconds)."""

    def __init__(self, events: list[dict]):
        spans: dict[str, list[tuple[float, float]]] = defaultdict(list)
        launches: dict[int, float] = {}
        device, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, e.get("name", ""), e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                launches[e.get("args", {}).get("correlation")] = ts
            if cat == "user_annotation":
                spans[e["name"]].append((ts, ts + dur))
            if cat in HOST_CATS:
                host.append((ts, ts + dur, e.get("name", "")))
        if not spans.get(WINDOW):
            raise RuntimeError("the profiler's trace holds no window range")
        self.w0, self.w1 = spans.pop(WINDOW)[0]
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}
        self.device = sorted(d for d in device if self.w0 <= d[0] and d[1] <= self.w1)
        self.launches = launches
        self.host = host

    # -- the window and the device --------------------------------------
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * US

    def _busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for s, e, _, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) * US

    # -- spans ----------------------------------------------------------
    def count(self, span: str) -> int:
        """Calls of ``span`` inside the window."""
        return sum(1 for s, e in self.spans.get(span, ()) if self.w0 <= s and e <= self.w1)

    def _in_span(self, span: str, ts: float) -> bool:
        i = bisect.bisect_right(self._starts[span], ts) - 1
        return i >= 0 and ts <= self.spans[span][i][1]

    def device_s(self, span: str) -> float:
        """Device time of the operations launched inside calls of ``span``."""
        if span not in self.spans:
            return 0.0
        total = 0.0
        for s, e, _, corr in self.device:
            ts = self.launches.get(corr)
            if ts is not None and self._in_span(span, ts):
                total += e - s
        return total * US

    # -- what the next reader sees --------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each by the innermost host operation that
        covers its middle."""
        by_name: dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.device:
            by_name[name] += (e - s) * US
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = [], self.w0
        for s, e in self._busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.w1 > last:
            gaps.append((last, self.w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        idle = []
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            covering = [(e - s, name) for s, e, name in self.host if s <= mid <= e]
            idle.append([min(covering)[1] if covering else "(no host operation)", (g1 - g0) * US])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}
