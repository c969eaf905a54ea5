"""The SAE forward's share of its roofline: the forward's least time
(``counts/sae.py``: the longest of the encode and decode at the bf16
peak, the select's compares at the ALU peak and its bytes at the memory
bandwidth) for each call of the ``sae.forward``
span, over the device time attributed to that span, in percent."""

from counts import sae


def read(run):
    t = run.trace
    n = t.count("sae.forward") if t is not None else 0
    busy = t.device_s("sae.forward") if n else 0.0
    if busy <= 0:
        return None
    d = run.cfg["d_model"]
    h, k = d * run.cfg["sae"]["expansion_factor"], run.cfg["sae"]["k"]
    return 100.0 * n * sae.forward_least_s(run.traffic["batch"], d, h, k) / busy
