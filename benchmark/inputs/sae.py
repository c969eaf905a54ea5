"""A TopK SAE's starting parameters and training rows, from the seed.

The parameters follow the TopK SAE's published init in distribution
(decoder xavier-uniform rows scaled to norm 0.1, encoder weight and bias
U(-1/sqrt(d), 1/sqrt(d))), in the ``x @ W`` layout the port takes
(``w_enc [d, h]``, ``w_dec [h, d]``), f32 as the trainer holds them.
The decoder and pre-encoder biases, zero at a real start, are drawn
small (0.05 N(0, 1)) so that the check sees them enter.  Rows are N(0, 1)
f32, the shape of a feature cache the trainer has staged on the card.
"""

from __future__ import annotations

import math

import torch

from harness import seeds


def params(d: int, h: int, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    g = seeds.generator(seed, "sae.params", device)
    u = torch.rand(2 * d * h + h, generator=g, device=device).mul_(2.0).sub_(1.0)
    z = torch.randn(2 * d, generator=g, device=device).mul_(0.05)
    enc = 1.0 / math.sqrt(d)
    w_dec = u[d * h:2 * d * h].view(h, d) * math.sqrt(6.0 / (d + h))
    w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True) * 0.1
    return {
        "w_enc": u[:d * h].view(d, h) * enc,
        "b_enc": u[2 * d * h:] * enc,
        "w_dec": w_dec.contiguous(),
        "b_dec": z[:d].clone(),
        "b_pre": z[d:].clone(),
    }


def rows(n: int, d: int, seed: int, tag: str, device: torch.device) -> torch.Tensor:
    return torch.randn(n, d, generator=seeds.generator(seed, tag, device), device=device)
