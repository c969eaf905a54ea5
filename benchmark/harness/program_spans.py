"""Readings of the program's own spans from a traced window.

The port opens these itself (``utils/profiling.span``: ``train.step``,
``train.backward``, ``train.update``, ``train.order``, ``extract.call``,
``encoder.forward``, ``decoder.forward``, ...) as ``record_function``
ranges whenever a profiler runs, so they sit in the profiled window's
trace beside the benchmark's own spans.  This module reads only what
:class:`trace.Trace` holds (``spans``, ``device``, ``launches``, ``w0``
and ``w1``; times in microseconds) and adds two reductions:

- idle time by span: the window's idle intervals (``[w0, w1]`` less the
  union of the device operations' intervals) split by exact overlap with
  the host intervals of a span's calls;
- operations a call: the device operations whose launching runtime or
  driver call falls inside a call of a span, over its calls.

A tree whose program opens no such span gives None: the metric is left
out of the result line.
"""

from __future__ import annotations

import bisect


def _merged(intervals) -> list[list[float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle_intervals(t) -> list[tuple[float, float]]:
    """The window's intervals in which no device operation runs."""
    idle, last = [], t.w0
    for s, e in _merged((s, e) for s, e, _, _ in t.device):
        if s > last:
            idle.append((last, s))
        last = max(last, e)
    if t.w1 > last:
        idle.append((last, t.w1))
    return idle


def _overlap(a, b) -> float:
    """The length of the overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(t, span: str) -> float | None:
    """The share of the window's idle time that overlaps the host
    intervals of ``span``'s calls, in percent; None without a device
    timeline, without idle time or without the span."""
    if t is None or not t.device or not t.spans.get(span):
        return None
    idle = _idle_intervals(t)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    calls = _merged((max(s, t.w0), min(e, t.w1)) for s, e in t.spans[span]
                    if e > t.w0 and s < t.w1)
    return 100.0 * _overlap(idle, calls) / total


def ops_per_call(t, span: str) -> float | None:
    """Device operations (kernels, copies, sets) launched inside calls of
    ``span``, over the span's calls inside the window; None without a
    device timeline or without a call."""
    n = t.count(span) if t is not None and t.device else 0
    if not n:
        return None
    calls = t.spans[span]
    starts = [s for s, _ in calls]
    ops = 0
    for _, _, _, corr in t.device:
        ts = t.launches.get(corr)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= calls[i][1]:
            ops += 1
    return ops / n
