"""Training's device memory: the most the CUDA allocator held at once in
the run, set-up and window, in GB (1e9 bytes): the same number as the
result's ``device.memory_peak_bytes``.  What the card has to hold for
the cell's stack, the trainer's state, the epoch's gathered copy and a
step's transients; the same shapes give the same peak from seed to
seed, so it holds where the host's pace makes the rate drift.  None off
the card."""


def read(run):
    if run.trace is not None or "peak" not in run.memory:
        return None
    return run.memory["peak"] / 1e9
