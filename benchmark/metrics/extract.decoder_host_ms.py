"""Host milliseconds a batch in the one-token decoder: the mean host-clock
duration of the ``whisper.decoder`` span's calls in the traced run's
unprofiled window (no profiler's cost in them)."""


def read(run):
    spans = run.host_spans.get("whisper.decoder", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
