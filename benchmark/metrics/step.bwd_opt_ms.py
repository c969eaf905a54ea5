"""Device milliseconds a training step outside the SAE forward: the
device time attributed to the ``trainer.step`` span less that of the
``sae.forward`` span inside it (the backward's products, the clip,
AdamW, the decoder renorm and the dead-feature update), over the
steps."""


def read(run):
    t = run.trace
    n = t.count("trainer.step") if t is not None else 0
    if not n:
        return None
    return 1e3 * (t.device_s("trainer.step") - t.device_s("sae.forward")) / n
