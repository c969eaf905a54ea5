"""The Whisper encoder's share of its roofline: the encoder forward's
least time (``counts/whisper.py``: the longest of the stem and every
layer at the bf16 peak, the softmax's exponentials at the ALU peak and
its bytes at the memory bandwidth) for each call of the
``whisper.encoder`` span, over the device time attributed to that span,
in percent."""

from counts import whisper


def read(run):
    t = run.trace
    n = t.count("whisper.encoder") if t is not None else 0
    busy = t.device_s("whisper.encoder") if n else 0.0
    if busy <= 0:
        return None
    g = whisper.Geometry.of(run.cfg, run.traffic["mel_frames"])
    return 100.0 * n * whisper.encoder_least_s(run.traffic["batch"], g) / busy
