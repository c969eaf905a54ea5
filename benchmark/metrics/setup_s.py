"""Set-up: from the start of the process to the first timed call (host
clock): imports, the kernel library's load (or first build), the
weights and inputs made from the seed, the check's first steps and the
warm-up of the window's shapes."""


def read(run):
    return run.setup_s
