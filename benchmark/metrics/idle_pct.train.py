"""The share of the traced training window in which no operation runs on
the device (the union of the device operations' intervals), in
percent."""


def read(run):
    if run.trace is None or run.traffic["kind"] != "train":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
