"""The share of extraction's wall time in which no operation runs on the
device, in percent: one less the device's busy time a clip (the union
of the device operations' intervals in the profiled window, over its
clips) over the wall time a clip of the traced run's unprofiled window.
The profiler's cost on the host (a fifth to a third of a batch's time
on this host-paced path) stays out of the wall time; a kernel's device
time is the same with or without it."""


def read(run):
    t, w = run.trace, run.host
    if t is None or run.traffic["kind"] != "extract" or not w.get("work"):
        return None
    busy_a_clip = t.busy_s / run.window["work"]
    return 100.0 * (1.0 - busy_a_clip * w["work"] / w["seconds"])
