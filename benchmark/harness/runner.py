"""One run of one cell: set-up, the measured (or traced) window, the
metrics, the check, and the result.

The cell's driver (``drivers/<kind>.py``, named by the mix's ``kind``)
holds what is particular to a kind of work.  It has:

- ``Driver(cfg, traffic, seed, device)``; ``setup()`` builds the program's
  objects and inputs from the seed, runs the first steps the check
  compares and warms every shape the window uses;
- ``unit()``: one call of the timed path, -> the work it completed
  (rows, clips);
- ``sync()``; ``attempted`` and ``failed``;
- ``spans()``: the ``(owner, attribute, span)`` the traced run wraps
  (the traced run runs the timed path for ``trace_seconds`` twice: with
  each span timed on the host clock, then under the profiler);
- ``route()``: the program's launch counts, printed as a check of the
  route the run took (no metric);
- ``release()``: drops the program's state once the window has closed;
- ``check()``: -> ``{number: value}``, the program's outputs against the
  plain reference, each compared with its limit in ``limits/<cell>.json``.

and, beside the class, ``readings(drv)``: -> ``{reading: {number:
value}}`` for one seed, ``program`` (the run's numbers), ``control``
and the faults the kind can have; ``calibrate.py`` prints them, and the
limits are set from them.

What ``unit()`` returns is the work that the end-to-end rates count
(``metrics/train_act_per_s.py``, ``metrics/extract_clips_per_s.py``),
in a cell that the rate's ``workloads`` list names: a new kind reports
a rate by returning that rate's unit of work, and by being listed.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import torch

from . import guard, spans, trace
from .spec import ROOT, Spec


@dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    cfg: dict
    traffic: dict
    setup_s: float | None = None
    window: dict = field(default_factory=dict)  # work, unit count, seconds (host clock)
    trace: trace.Trace | None = None  # traced runs: the profiled window (``window``)
    host: dict = field(default_factory=dict)  # traced runs: the unprofiled window before it
    host_spans: dict = field(default_factory=dict)  # its spans' host seconds, a list each
    # on the card, the allocator's bytes: ``window_start`` (allocated as the window opens),
    # ``window_peak`` (the most while it ran), ``peak`` (the most in the run, set-up included)
    memory: dict = field(default_factory=dict)


def program_on_path() -> None:
    """The port's package from the checkout's ``src/``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _loop(drv, seconds: float) -> dict:
    """Units of the timed path until ``seconds`` have passed, then a
    synchronisation: all the work over all the time."""
    work = units = 0
    t0 = time.perf_counter()
    while True:
        work += drv.unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    drv.sync()
    return {"work": work, "units": units, "seconds": time.perf_counter() - t0, "t0": t0}


def run_cell(spec: Spec, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, started: float) -> dict:
    """Run the cell once -> the result's fields, ``checks`` last."""
    cell = spec.cell(name)
    cfg, traffic, limits = spec.config(cell), spec.traffic(cell), spec.limits(cell)
    program_on_path()
    drv = spec.driver(traffic["kind"]).Driver(cfg, traffic, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    run = Run(cell, cfg, traffic)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)  # from here, the window's own peak
        run.memory["window_start"] = torch.cuda.memory_allocated(device)
    if traced:
        # the host-clock readings first, with no profiler's cost in them
        with spans.installed(drv.spans(), spans.timed(run.host_spans)):
            run.host = _loop(drv, traffic["trace_seconds"])
        with spans.installed(drv.spans()):
            run.window, run.trace = trace.record(lambda: _loop(drv, traffic["trace_seconds"]))
    else:
        run.window = _loop(drv, seconds)
        run.setup_s = run.window["t0"] - started
    peak = 0
    if cuda:
        run.memory["window_peak"] = torch.cuda.max_memory_allocated(device)
        peak = run.memory["peak"] = max(setup_peak, run.memory["window_peak"])
    guard.refuse_forbidden_modules()
    drv.release()
    numbers = drv.check()
    checks = {k: {"value": numbers[k], "limit": float(limits[k])} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec.metrics(cell, traced):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(drv.attempted),
              "failed": int(drv.failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["route"] = drv.route()
    result["checks"] = checks
    return result
