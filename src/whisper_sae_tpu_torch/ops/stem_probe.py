"""The conv stem timed on the card.

Times ``cuda_encoder.conv_stem_fwd`` (weights prepared by a first call)
and the ``F.conv1d`` pair of the same convolutions (bf16, the yardstick:
no GELU, no positions) between CUDA events, each in one order and then
in the reverse order, and the device time a call of every kernel the
stem launches, by name, under ``torch.profiler``; at whisper-tiny (64
clips, 80 mels, D=384) and whisper-large-v3 (16 clips, 128 mels,
D=1280), 3000 mel frames a clip, random weights and mel.  Prints the
card's name and power limit first and one JSON object last.  Needs one
H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.stem_probe
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from . import _probe, cuda_encoder
from ._probe import time_ms

GEOMS = {"whisper_tiny": (64, 80, 384), "whisper_large_v3": (16, 128, 1280)}  # clips, mels, D
T_MEL = 3000
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, dense bf16; HBM3


def inputs(b: int, n_mels: int, d: int) -> tuple:
    """mel ``[b, n_mels, T_MEL]`` and the stem's weights, biases and
    positions, bf16 on the card."""
    g = torch.Generator(device="cuda").manual_seed(d)

    def r(*shape, scale):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    return (r(b, n_mels, T_MEL, scale=0.5), r(d, n_mels, 3, scale=(3 * n_mels) ** -0.5),
            r(d, scale=0.1), r(d, d, 3, scale=(3 * d) ** -0.5), r(d, scale=0.1),
            r(T_MEL // 2, d, scale=0.1))


def bound_ms(b: int, n_mels: int, d: int) -> float:
    """The least time of a call: conv1 at the 2T mel frames and conv2 at
    the T output frames at the bf16 peak, or the mel, the weights, the
    positions and the output once each at the memory rate."""
    t = T_MEL // 2
    flops = 2 * b * t * d * (6 * n_mels + 3 * d)
    nbytes = 2 * (b * n_mels * T_MEL + 3 * n_mels * d + 3 * d * d + t * d + b * t * d)
    return 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_probe needs a CUDA card")
        return 1
    res = {"card": _probe.card()}
    print(res["card"])
    for model, (b, n_mels, d) in GEOMS.items():
        mel, w1, b1, w2, b2, pos = inputs(b, n_mels, d)
        fns = {
            "stem_ms": lambda: cuda_encoder.conv_stem_fwd(mel, w1, b1, w2, b2, pos),
            "conv1d_pair_ms": lambda: F.conv1d(F.conv1d(mel, w1, b1, padding=1), w2, b2,
                                               stride=2, padding=1),
        }
        readings = {key: [] for key in fns}
        for order in (list(fns), list(fns)[::-1]):
            for key in order:
                readings[key].append(time_ms(fns[key]))
        row = {"clips": b, "n_mels": n_mels, "d": d, "bound_ms": bound_ms(b, n_mels, d),
               **readings, "launches_ms": _probe.device_split(fns["stem_ms"])}
        res[model] = row
        print(f"{model}: " + ", ".join(f"{k} {v}" for k, v in row.items()))
        del mel, w1, w2, pos, fns
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
