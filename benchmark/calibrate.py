"""Readings that set the check's limits, for one cell, in one process.

    python3 benchmark/calibrate.py --workload tiny8x.train --seeds 1,2,3 [--out FILE]

On the GPU, at the cell's own sizes, for each seed, the readings of the
cell's driver (``drivers/<kind>.py``, named by the mix's ``kind``): its
module-level ``readings(drv)``, given a fresh ``Driver`` of the cell.
A driver without one stops the calibration with its kind named.  Every
kind's readings hold:

- ``program``: the program's numbers against the plain reference, as a
  run's check reads them;
- ``control``: the reference computed in the nearest precision below
  the one the configuration states, put in the program's place;
- the faults the cell can have, each under a name of its own.

The training driver's: the first three steps and the window call's two
late steps; the control in fp8; ``half`` (half of each batch left out,
the mean over the rest) and ``offset`` (each late step's loss on the
rows of the step before it, as a read at the wrong offset into the
epoch's buffer gives).  A training step that leaves its state unchanged
reads 1 on ``delta3`` by its definition and needs no run.  The
extraction driver's: a batch through the timed call; the control in
fp8; ``answer`` (one clip's captures swapped with another's).

Prints one JSON line a seed and reading, and writes them all to
``--out``.  ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from harness import guard
from harness.runner import program_on_path
from harness.spec import ROOT, Spec


def readings_for(spec: Spec, kind: str):
    """``readings(drv)`` of the driver of ``kind`` (``drivers/<kind>.py``):
    each kind of work brings the readings of its own limits."""
    readings = getattr(spec.driver(kind), "readings", None)
    if readings is None:
        raise SystemExit(f"calibrate: the driver of kind {kind!r} (drivers/{kind}.py) has no "
                         "readings(drv), so no limit of its cells can be read")
    return readings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out")
    args = ap.parse_args()
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    program_on_path()
    readings = readings_for(spec, traffic["kind"])
    driver = spec.driver(traffic["kind"]).Driver
    device = guard.require_cards(int(cell["chips"]))
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(driver(cfg, traffic, seed, device))
        line = {"workload": args.workload, "seed": seed, **out,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
