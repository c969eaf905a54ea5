"""Exact threshold-mask top-k, plain PyTorch (counterpart of
``whisper_sae_tpu/ops/topk.py:42-89``).

The k-th largest value of each row is found by 32 halvings of the int32
range of the monotone integer view of its f32 bits, so ``x >= th``
selects exactly the k largest entries; ties at the threshold admit more
than k, which ``torch.topk`` (exactly k) cannot stand in for.  Selection
comes before the relu, as in the reference encode.

This module is the plain version of kernel C (``ops/cuda_topk.py``): the
dispatch sends a CUDA tensor to the kernel and a CPU tensor here.
"""

from __future__ import annotations

import torch


def _monotone_int(pre: torch.Tensor) -> torch.Tensor:
    """Bitcast f32 -> int32 such that float order == integer order.

    ``x ^ 0x7fffffff`` equals ``INT_MIN - x - 1`` for negative ``x`` without
    an intermediate overflow."""
    x = pre.contiguous().view(torch.int32)
    return torch.where(x < 0, x ^ 0x7FFFFFFF, x)


def topk_threshold(pre: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (x, th): the monotone int view of ``pre`` and, per row, the
    largest ``th`` with ``count(x >= th) >= k`` (shape ``[..., 1]``)."""
    x = _monotone_int(pre)
    shape = pre.shape[:-1] + (1,)
    lo = torch.full(shape, -2147483647, dtype=torch.int32, device=pre.device)
    hi = torch.full(shape, 2147483647, dtype=torch.int32, device=pre.device)
    for _ in range(32):
        # overflow-safe midpoint; >> on int32 is arithmetic
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = (x >= mid).sum(dim=-1, keepdim=True)
        take = cnt >= k
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return x, lo


def topk_mask_plain(pre: torch.Tensor, k: int) -> torch.Tensor:
    """relu(pre) where pre is among the row's k largest, else 0."""
    x, th = topk_threshold(pre, k)
    return torch.where(x >= th, torch.relu(pre), torch.zeros((), dtype=pre.dtype, device=pre.device))


def topk_mask_dense(pre: torch.Tensor, k: int) -> torch.Tensor:
    """Dense top-k activation with the straight-through-the-selection
    gradient ``g * [hidden > 0]``: kernel C for a CUDA tensor, the plain
    version above for a CPU tensor."""
    from .cuda_topk import topk_mask

    return topk_mask(pre, k)
