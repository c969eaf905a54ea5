"""Extraction's share of the chip's bf16 peak: the model FLOPs of the
batches in the traced run's unprofiled window (``counts/whisper.py``:
the encoder, and the decoder's token with its cross-attention K/V over
the encoder's frames) over that window's wall time, which ends in a
synchronisation, at 989 TFLOP/s, in percent."""

from counts import peaks, whisper


def read(run):
    w = run.host
    if run.traffic["kind"] != "extract" or not w.get("units"):
        return None
    g = whisper.Geometry.of(run.cfg, run.traffic["mel_frames"])
    flops = w["units"] * whisper.extract_model_flops(run.traffic["batch"], g)
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
