"""The share of the traced extraction window's device idle time that
falls inside the program's ``encoder.forward`` span (the body of
``models.whisper.encoder_forward``), in percent: idle intervals split by
exact overlap with the span's host intervals
(``harness/program_spans.py``).  Of idle time, not of the window: the
profiler's cost on the host inflates idle time, less so its shares."""

from harness import program_spans


def read(run):
    return program_spans.idle_share(run.trace, "encoder.forward")
