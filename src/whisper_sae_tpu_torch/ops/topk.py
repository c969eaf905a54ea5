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

from collections import Counter

import torch

# Calls of the SAE kernels' plain versions (kernels A, B, C, their wide and
# blocked forms) by route, counted where a wrapper takes one for a CPU
# tensor: a run on the card whose count moved did not go through its kernels.
plain_calls: Counter = Counter()


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


def cta_threshold(pre: torch.Tensor, k: int, threads: int = 512,
                  warp: int = 32) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' CTA-per-row select (``csrc/topk_common.cuh:
    cta_kth_largest``) on each row of a 2-D ``pre``, transcribed: thread t
    holds elements j*threads + t (INT_MIN past the row), each pass counts
    per thread, sums each warp's lanes, then the warps, and a row leaves
    the loop at the first pass whose total is exactly k, else after 32
    passes at ``lo``.  -> (x, th [rows, 1], passes [rows]).  Any threshold
    in (v_{k+1}, v_k] selects what :func:`topk_threshold`'s does."""
    x = _monotone_int(pre)
    rows, h = x.shape
    slots = torch.full((rows, -(-h // threads) * threads), -2147483648, dtype=torch.int32,
                       device=pre.device)
    slots[:, :h] = x
    slots = slots.view(rows, -1, threads // warp, warp)  # [row, j, warp, lane]
    lo = torch.full((rows,), -2147483647, dtype=torch.int32, device=pre.device)
    hi = torch.full_like(lo, 2147483647)
    th, passes = lo.clone(), torch.zeros_like(lo)
    done = torch.zeros(rows, dtype=torch.bool, device=pre.device)
    for _ in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        per_thread = (slots >= mid[:, None, None, None]).sum(dim=1)  # [row, warp, lane]
        total = per_thread.sum(dim=2).sum(dim=1)  # each warp's sum, then the CTA's
        live = ~done
        passes += live.int()
        hit = live & (total == k)
        th = torch.where(hit, mid, th)
        lo = torch.where(live & (total > k), mid, lo)
        hi = torch.where(live & (total < k), mid, hi)
        done |= hit
    return x, torch.where(done, th, lo)[:, None], passes


def group_threshold(pre: torch.Tensor, k: int, threads: int = 128, run: int = 4,
                    warp: int = 32, cand: int = 256
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wide routes' group-form select (``csrc/select_decode.cuh:
    group_kth_largest``) on each row of a 2-D ``pre``, transcribed: a warp
    group of ``threads`` threads holds the row, thread t the runs of
    ``run`` values c = q*threads*run + run*t + i (INT_MIN past the row, in
    32, 48 or 64 slots a thread: ``group_per_thread``); each pass counts
    per thread, sums each warp's lanes, then the group's warps, and a row
    leaves the loop at the first pass whose total is exactly k, else after
    32 passes at ``lo``.  Once passes have set both bounds and at most
    ``cand`` values lie in [lo, hi) (the totals at lo and hi apart), those
    values are the candidates and each later total is the total at hi
    then plus the candidates >= mid (the kernel's warp 0 alone counts
    them; ``cand=0``: never).  -> (x, th [rows,
    1], passes [rows]).  The midpoints and totals are
    :func:`cta_threshold`'s, so the threshold, the pass count and the mask
    are too."""
    x = _monotone_int(pre)
    rows, h = x.shape
    per = 32 if h <= 32 * threads else 48 if h <= 48 * threads else 64
    if h > per * threads:
        raise ValueError(f"the group form holds rows of at most {64 * threads} values (got {h})")
    slots = torch.full((rows, per * threads), -2147483648, dtype=torch.int32, device=pre.device)
    slots[:, :h] = x
    # [row, q, warp, lane, i]: value q*threads*run + run*(warp*32 + lane) + i
    slots = slots.view(rows, per // run, threads // warp, warp, run)
    lo = torch.full((rows,), -2147483647, dtype=torch.int32, device=pre.device)
    hi = torch.full_like(lo, 2147483647)
    c_lo, c_hi = torch.full_like(lo, -1), torch.full_like(lo, -1)
    th, passes = lo.clone(), torch.zeros_like(lo)
    done = torch.zeros(rows, dtype=torch.bool, device=pre.device)
    compact = torch.zeros_like(done)
    in_cand = torch.zeros_like(slots, dtype=torch.bool)

    def b(t):  # a per-row value against the slots
        return t[:, None, None, None, None]

    for _ in range(32):
        now = ~compact & ~done & (c_lo >= 0) & (c_hi >= 0) & (c_lo - c_hi <= cand)
        in_cand = torch.where(b(now), (slots >= b(lo)) & (slots < b(hi)), in_cand)
        compact |= now
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        ge = slots >= b(mid)
        per_thread = torch.where(b(compact), ge & in_cand, ge).sum(dim=(1, 4))  # [row, warp, lane]
        total = per_thread.sum(dim=2).sum(dim=1)  # each warp's sum, then the group's
        total = torch.where(compact, total + c_hi, total)
        live = ~done
        passes += live.int()
        hit = live & (total == k)
        th = torch.where(hit, mid, th)
        up, down = live & (total > k), live & (total < k)
        lo, c_lo = torch.where(up, mid, lo), torch.where(up & ~compact, total, c_lo)
        hi, c_hi = torch.where(down, mid, hi), torch.where(down & ~compact, total, c_hi)
        done |= hit
    return x, torch.where(done, th, lo)[:, None], passes


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
