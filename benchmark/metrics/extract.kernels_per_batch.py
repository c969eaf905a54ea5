"""Device operations (kernels, copies, sets) a batch of extraction: those
launched inside the program's ``extract.call`` span (the body of
``models.whisper.extract_activations``) over its calls in the traced
window (``harness/program_spans.py``).  A count: the same in every run
of a route, but for any launch the profiler misses."""

from harness import program_spans


def read(run):
    return program_spans.ops_per_call(run.trace, "extract.call")
