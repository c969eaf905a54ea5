"""Readings that set the check's limits, for one cell, in one process.

    python3 benchmark/calibrate.py --workload tiny8x.train --seeds 1,2,3 [--out FILE]

On the GPU, at the cell's own sizes, for each seed:

- ``program``: the program's numbers against the plain reference, as a
  run's check reads them (the training cells' first three steps and the
  window call's two late steps; an extraction batch through the timed
  call);
- ``control``: the reference computed with fp8 operands, put in the
  program's place;
- the faults the cell can have, planted in the reference put in the
  program's place: ``half`` (training: half of each batch left out, the
  mean over the rest), ``offset`` (training: each late step's loss on
  the rows of the step before it, as a read at the wrong offset into
  the epoch's buffer gives) and ``answer`` (extraction: one clip's
  captures swapped with another's).  A training step that leaves its
  state unchanged reads 1 on ``delta3`` by its definition and needs no
  run.

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


def train_readings(drv) -> dict:
    from reference import sae_train as ref

    drv.setup()
    late = drv.late_steps()
    # the rows of the step before each late one: what a read at the wrong offset takes
    prev = drv.window_rows([s - 1 for s in late])
    drv.release()
    bf16, bf16_late = drv.reference(), drv.late_reference()

    def numbers(steps, late_losses):
        return {**ref.compare(steps, bf16, drv.params0),
                "late_loss": ref.late_gap(late_losses, bf16_late)}

    offset = {s: ref.loss_at(drv.late["params"][s], prev[s - 1], drv.k) for s in late}
    return {"program": numbers(drv.program, drv.late["loss"]),
            "control": numbers(drv.reference("fp8"), drv.late_reference("fp8")),
            "half": numbers(drv.reference(half=True), drv.late_reference(half=True)),
            "offset": {"late_loss": ref.late_gap(offset, bf16_late)}}


def extract_readings(drv) -> dict:
    from reference import whisper_extract as ref

    drv.build()
    drv.unit()
    drv.sync()
    (j, enc, dec), = drv.kept.values()
    mel, block = drv.mels[j], drv.traffic["reference_block"]
    out = {"program": drv.check()}
    enc8, dec8 = ref.captures(drv.params, drv.cfg, mel, "fp8", block)
    out["control"] = ref.compare(drv.params, drv.cfg, mel, enc8, dec8, block=block)
    swapped = enc.clone()
    swapped[:, [0, 1]] = enc[:, [1, 0]]
    out["answer"] = ref.compare(drv.params, drv.cfg, mel, swapped, dec, block=block)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out")
    args = ap.parse_args()
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    device = guard.require_cards(int(cell["chips"]))
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    program_on_path()
    driver = spec.driver(traffic["kind"]).Driver
    readings = train_readings if traffic["kind"] == "train" else extract_readings
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
