"""Training throughput: the work of every call the window completed
over the window's wall time, which ends in a synchronisation (host
clock).

The work counted is whatever the cell's driver's ``unit()`` returns, in
act/s: for the training driver, the rows of the optimizer steps each
call completed.  The metric's ``workloads`` list in ``BENCHMARK.json``
chooses the cells that report it; the reader reads any of them."""


def read(run):
    if run.trace is not None:
        return None
    return run.window["work"] / run.window["seconds"]
