"""Whisper weights and log-mel batches, from the seed.

The weights are one bf16 draw of N(0, 1) on the device, cut into views,
each starting on a 256-byte boundary, and scaled in place so that a
layer keeps its input's scale: each matrix (and convolution) by
``1/sqrt(fan_in)``, biases and LN shifts by 0.02, LN gains ``1 + 0.02
N(0, 1)``, the decoder's embeddings as drawn.  So every capture depends
on its clip's mels.  They are laid out as the
port's parameter tree: linear weights in the ``x @ W`` layout, the
layers of each stack on a leading ``[L]`` axis; the encoder's positions
are Whisper's fixed sinusoids.  bf16 is the type extraction serves them
in.  The mels are one draw of ``scale`` · N(0, 1) in bf16,
``[pool, batch, n_mels, t_mel]``: a pool of distinct batches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import seeds

ALIGN = 128  # elements: 256 bytes of bf16


def _shapes(cfg: dict) -> dict:
    d, f, n_mels = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    le, ld = cfg["encoder_layers"], cfg["decoder_layers"]

    def attn(n):
        return {"wq": (n, d, d), "bq": (n, d), "wk": (n, d, d), "wv": (n, d, d), "bv": (n, d),
                "wo": (n, d, d), "bo": (n, d)}

    def layers(n, cross):
        lp = {"attn": attn(n), "ln1_g": (n, d), "ln1_b": (n, d),
              "mlp": {"w1": (n, d, f), "b1": (n, f), "w2": (n, f, d), "b2": (n, d)},
              "ln2_g": (n, d), "ln2_b": (n, d)}
        if cross:
            lp.update(xattn=attn(n), ln_x_g=(n, d), ln_x_b=(n, d))
        return lp

    return {
        "encoder": {"conv1_w": (d, n_mels, 3), "conv1_b": (d,), "conv2_w": (d, d, 3),
                    "conv2_b": (d,), "layers": layers(le, False), "ln_f_g": (d,), "ln_f_b": (d,)},
        "decoder": {"tok": (cfg["vocab_size"], d), "pos": (cfg["max_target_positions"], d),
                    "layers": layers(ld, True), "ln_f_g": (d,), "ln_f_b": (d,)},
    }


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder positions: sin then cos, timescales from 1 to 10000."""
    inv = np.exp(-np.log(10000.0) / (channels // 2 - 1) * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def params(cfg: dict, seed: int, device: torch.device) -> dict:
    shapes = _shapes(cfg)
    offsets, total = [], 0
    for path, shape in _leaves(shapes):
        offsets.append((path, shape, total))
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.randn(total, dtype=torch.bfloat16, device=device,
                       generator=seeds.generator(seed, "whisper.params", device))
    tree: dict = {}
    for path, shape, off in offsets:
        leaf = flat[off:off + math.prod(shape)].view(shape)
        name = path[-1]
        if name.startswith("conv"):
            if name.endswith("_w"):
                leaf.mul_((shape[1] * shape[2]) ** -0.5)
            else:
                leaf.mul_(0.02)
        elif name.startswith("w"):
            leaf.mul_(shape[-2] ** -0.5)
        elif name.endswith("_g"):
            leaf.mul_(0.02).add_(1.0)
        elif name not in ("tok", "pos"):
            leaf.mul_(0.02)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    pos = sinusoids(cfg["max_source_positions"], cfg["d_model"])
    tree["encoder"]["pos"] = torch.from_numpy(pos).to(device, torch.bfloat16)
    return tree


def mels(cfg: dict, pool: int, batch: int, t_mel: int, scale: float, seed: int,
         device: torch.device) -> torch.Tensor:
    g = seeds.generator(seed, "whisper.mels", device)
    return torch.randn(pool, batch, cfg["num_mel_bins"], t_mel, dtype=torch.bfloat16,
                       device=device, generator=g).mul_(scale)
