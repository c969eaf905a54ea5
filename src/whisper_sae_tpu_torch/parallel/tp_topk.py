"""Exact top-k threshold over a feature-sharded pre-activation
(counterpart of ``whisper_sae_tpu/parallel/tp_topk.py``).

With the feature dim H split over the mesh's ``model`` ranks, the 32
halvings of the bit-bisection threshold (``ops/topk.py``) need only the
GLOBAL count of entries >= mid at each step: this rank's count,
all-reduced over the model group -- a ``[B, 1]`` int32 all-reduce per
halving instead of an all-gather of the ``[B, H]`` pre.  The JAX package
computes this in plain XLA (no Pallas kernel), so it is plain PyTorch
here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.topk import _monotone_int, relu


def topk_threshold_sharded(pre_local: torch.Tensor, k: int, group
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact global k-th-largest threshold of a feature-sharded array.

    ``pre_local`` is this rank's ``[..., H_local]`` slice, ``k`` the global
    number of active features, ``group`` the ranks holding the other
    slices.  -> (x_local, th): the monotone int32 view of the slice and the
    global threshold ``[..., 1]``; the local mask is ``x_local >= th``."""
    x = _monotone_int(pre_local)
    shape = pre_local.shape[:-1] + (1,)
    lo = torch.full(shape, -2147483647, dtype=torch.int32, device=pre_local.device)
    hi = torch.full(shape, 2147483647, dtype=torch.int32, device=pre_local.device)
    for _ in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = (x >= mid).sum(dim=-1, keepdim=True, dtype=torch.int32)
        dist.all_reduce(cnt, group=group)
        take = cnt >= k
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return x, lo


def topk_mask_sharded(pre_local: torch.Tensor, k: int, group) -> torch.Tensor:
    """relu(pre) on this rank's feature slice where pre is among the
    GLOBAL top-k, else 0: the slices' union is bit for bit the
    single-device ``topk_mask_dense``.  Differentiable in ``pre_local``."""
    x, th = topk_threshold_sharded(pre_local.detach(), k, group)
    return torch.where(x >= th, relu(pre_local), torch.zeros((), dtype=pre_local.dtype,
                                                              device=pre_local.device))
