"""Profiling instrumentation (counterpart of
``whisper_sae_tpu/utils/profiling.py``): a ``torch.profiler`` trace
behind a flag, and the program's spans.

A span names a piece of the port's hot path (``train.backward``,
``encoder.forward``, ...).  While a ``torch.profiler`` profile runs --
``trace`` here, or any other -- it is a ``record_function`` range, so it
lands in the profiler's trace beside the kernels, on the profiler's
clock, and the launch correlation ids tie each kernel to the span that
launched it.  With no profiler running it is one check and a shared
context that does nothing: building a range costs ~15 us a call even
when nothing records it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path

import torch
from torch.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """A span with no profiler running: enters and leaves doing nothing.
    As a decorator it opens its span afresh at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


_OFF: dict[str, _Off] = {}


def span(name: str):
    """The program span ``name``, as a context manager or a decorator:
    a ``record_function`` range while a profiler runs, else the span's
    one shared null context.

        with span("train.backward"):
            grads = torch.autograd.grad(loss, params)

        @span("train.order")
        def _epoch_permutation(...): ...
    """
    if _profiler_enabled():
        return record_function(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


@contextlib.contextmanager
def trace(trace_dir: str | Path | None):
    """Record the CPU (and, where there is a card, CUDA) activity of the
    block with ``torch.profiler`` and write it into ``trace_dir`` as a
    Chrome trace, ``trace_<pid>_<ns>.json``, the program's spans among
    its ranges; no-op for ``None``.

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
