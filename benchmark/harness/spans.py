"""Spans around calls into the program, opened from the benchmark's own
code: at run time a method or module-level function the program calls
is replaced by a wrapper that runs it inside a
``torch.profiler.record_function`` range of the span's name (the
profiled window) or times it on the host clock (the traced run's
unprofiled window).  No program file is edited; only the traced run
installs them, and the training driver's set-up, which keeps a late
step's parameters the same way.

A driver names its spans as ``(owner, attribute, span)``: ``owner`` a
class or module of the program.  Functions the program looks up by
their module's global name at call time (``models.whisper``'s
``encoder_forward`` inside ``extract_activations``) and methods looked
up on the instance both reach the wrapper.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch


def traced(fn, name: str):
    """``fn`` inside a profiler range named ``name``."""

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return spanned


def timed(store: dict[str, list[float]]):
    """A wrapper maker: each call's host seconds (``perf_counter``, no
    profiler) appended to ``store[name]``."""

    def wrap(fn, name: str):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                store.setdefault(name, []).append(time.perf_counter() - t0)

        return spanned

    return wrap


@contextlib.contextmanager
def installed(targets, wrap=traced):
    """Install ``wrap(original, span)`` for each of ``targets`` for the
    block, then restore the program's own attributes."""
    saved = []
    try:
        for owner, attr, name in targets:
            original = owner.__dict__[attr]
            saved.append((owner, attr, original))
            setattr(owner, attr, wrap(original, name))
        yield
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)
