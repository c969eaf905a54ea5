"""Extraction throughput: the clips of all batches the window completed
over the window's wall time, which ends in a synchronisation (host
clock)."""


def read(run):
    if run.traffic["kind"] != "extract" or run.trace is not None:
        return None
    return run.window["work"] / run.window["seconds"]
