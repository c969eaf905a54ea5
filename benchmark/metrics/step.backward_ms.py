"""Device milliseconds a training step in the backward: the device time
of the operations launched inside the program's ``train.backward`` span
(``torch.autograd.grad`` in ``SAETrainer._step``: the backward's
products and casts), over the calls of its ``train.step`` span."""


def read(run):
    t = run.trace
    n = t.count("train.step") if t is not None else 0
    if not n:
        return None
    return 1e3 * t.device_s("train.backward") / n
