"""The trainer's own device memory in the window, in GB (1e9 bytes): the
most the allocator held while the window's calls ran, less what it held
as the window opened (the stack, the parameters and optimizer state, and
what set-up keeps for the check).  Each epoch's gathered copy of its
rows and each step's transients (pre-activations, latents, gradients,
the backward's scratch).  None off the card."""


def read(run):
    if run.trace is None or "window_peak" not in run.memory:
        return None
    return (run.memory["window_peak"] - run.memory["window_start"]) / 1e9
