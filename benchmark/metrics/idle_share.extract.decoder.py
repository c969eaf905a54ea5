"""The share of the traced extraction window's device idle time that
falls inside the program's ``decoder.forward`` span (the body of
``models.whisper.decoder_forward``, the one-token decoder), in percent:
idle intervals split by exact overlap with the span's host intervals
(``harness/program_spans.py``).  Host time in the decoder while the
device still runs the encoder's queued kernels is not idle, so not
counted here."""

from harness import program_spans


def read(run):
    return program_spans.idle_share(run.trace, "decoder.forward")
