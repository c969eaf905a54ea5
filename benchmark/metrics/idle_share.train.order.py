"""The share of the traced training window's device idle time that falls
inside the program's ``train.order`` span (``SAETrainer._epoch_permutation``:
the epoch order drawn on the host and uploaded), in percent: idle
intervals split by exact overlap with the span's host intervals
(``harness/program_spans.py``).  Times ``idle_pct.train``, the share of
the window."""

from harness import program_spans


def read(run):
    return program_spans.idle_share(run.trace, "train.order")
