"""Training throughput: the rows of all steps the window's calls
completed over the window's wall time, which ends in a synchronisation
(host clock)."""


def read(run):
    if run.traffic["kind"] != "train" or run.trace is not None:
        return None
    return run.window["work"] / run.window["seconds"]
