"""Kernels A, B and C timed alone on the card, for comparing two trees.

Times ``cuda_sae._fused_loss_launch`` (kernel A, sliced), kernel B's
``_topk_encode_launch`` (bf16 latent) and kernel C's ``topk_mask_fwd`` at
whisper-tiny's width (D=384, H=3072, k=32) on 128, 4096 and 32768 rows of
seeded gaussian data, each over 20 launches between CUDA events after 3
warm ones.  The kernels are those of the package found on the import
path, built from its own sources, so the same command run with another
tree's ``src`` first on ``PYTHONPATH`` times that tree: run the two in
turns (parent, change, change, parent) in one call to compare them on
one card.  Prints the card's name and power limit, then one JSON line.
Needs one H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.sae_probe
"""

from __future__ import annotations

import json

import torch

from . import _build, _probe, cuda_sae, cuda_topk
from ._probe import time_ms

D, H, K = 384, 3072, 32
ROWS = (128, 4096, 32768)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sae_probe: needs a CUDA device")
    dev = torch.device("cuda")
    card = _probe.card()
    print(card, flush=True)
    _build.load_library()
    g = torch.Generator().manual_seed(0)
    w_enc, b_enc, b_pre = (torch.randn(D, H, generator=g) * 0.05, torch.randn(H, generator=g) * 0.05,
                           torch.randn(D, generator=g) * 0.05)
    w_dec, b_dec = torch.randn(H, D, generator=g) * 0.05, torch.randn(D, generator=g) * 0.05
    w_enc, b_enc, b_pre, w_dec, b_dec = (t.to(dev) for t in (w_enc, b_enc, b_pre, w_dec, b_dec))
    we_t, wd, b_out = cuda_sae._bf16_t(w_enc), w_dec.bfloat16(), b_dec + b_pre
    res = {"card": card, "src": cuda_sae.__file__}
    for rows in ROWS:
        x = torch.randn(rows, D, generator=g).to(dev)
        pre = (torch.randn(rows, H, generator=g)).to(dev)
        res[str(rows)] = {
            "fused_sae_loss": time_ms(lambda: cuda_sae._fused_loss_launch(
                x, 0, rows, we_t, b_enc, b_pre, wd, b_out, K)),
            "fused_topk_encode": time_ms(lambda: cuda_sae._topk_encode_launch(
                x, we_t, b_enc, b_pre, K, torch.bfloat16)),
            "topk_mask": time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K)),
        }
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
