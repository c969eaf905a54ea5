"""Device milliseconds a training step after the backward: the device
time of the operations launched inside the program's ``train.update``
span (``SAETrainer._step``'s no-grad block: the clip, AdamW, the decoder
renorm, the dead-feature update and the metric row), over the calls of
its ``train.step`` span."""


def read(run):
    t = run.trace
    n = t.count("train.step") if t is not None else 0
    if not n:
        return None
    return 1e3 * t.device_s("train.update") / n
