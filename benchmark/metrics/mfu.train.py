"""The training step's share of the chip's bf16 peak: the model FLOPs of
the steps in the traced run's unprofiled window (``counts/sae.py``: the
encode, and the decode, dW_enc and dW_dec over the k selected latents a
row) over that window's wall time, which ends in a synchronisation, at
989 TFLOP/s, in percent."""

from counts import peaks, sae


def read(run):
    w = run.host
    if run.traffic["kind"] != "train" or not w.get("work"):
        return None
    b, d = run.traffic["batch"], run.cfg["d_model"]
    h, k = d * run.cfg["sae"]["expansion_factor"], run.cfg["sae"]["k"]
    flops = w["work"] // b * sae.step_model_flops(b, d, h, k)
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
