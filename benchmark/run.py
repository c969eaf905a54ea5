"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload tiny8x.train --seed 7 --seconds 10 --trace 0

from the root of a checkout on a machine with the GPUs the cell asks
for.  ``--trace 0`` measures the cell's end-to-end metrics over a window
of ``--seconds``; ``--trace 1`` profiles a short window and reports its
per-layer metrics.  Either way the last lines of standard error give
each number the check compared beside its limit, and the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced),
then ``checks``.  Without a card, with too few, or with JAX loaded, it
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from harness import guard

STARTED = guard.process_start()
ROOT = Path(__file__).resolve().parents[1]
# every cache the program or its libraries keep lies at a fixed path in the
# checkout, so only a cell's first run in a checkout builds or compiles
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

import argparse  # noqa: E402
import json  # noqa: E402

from harness.runner import run_cell  # noqa: E402
from harness.spec import Spec  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    try:
        device = guard.require_cards(int(cell["chips"]))
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          device, STARTED)
        # again after every reader and the check: any of them may have loaded more
        guard.refuse_forbidden_modules()
    except guard.RefusedRun as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    print(f"route: {json.dumps(result['route'])}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
