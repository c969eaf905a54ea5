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

from . import _build

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


def _bisect(slots: torch.Tensor, k: int, cand: int, total_of, top: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' pass loop on each row.  ``slots`` [rows, ...] holds
    each row's monotone ints as the form's threads hold them (INT_MIN past
    the row, which no midpoint counts); ``total_of`` sums a boolean tensor
    of that layout to each row's total in the form's order.  A row leaves
    at the first pass whose total is exactly k, else after 32 passes at
    ``lo``.  With ``cand`` > 0, once passes have set both bounds and at most
    ``cand`` values lie in [lo, hi) (the totals at lo and hi apart), those
    values are the candidates and each later total is the total at hi then
    plus the candidates >= mid (``cand=0``: never).  With ``top`` (each
    row's largest value) a pass after the first two whose mid lies above
    it counts nothing (its total is known).  -> (th [rows, 1], passes, the
    passes over the whole row that count, the candidates (0 where none),
    the passes on the candidates that count), the last four [rows]."""
    rows = slots.shape[0]
    lo = torch.full((rows,), -2147483647, dtype=torch.int32, device=slots.device)
    hi = torch.full_like(lo, 2147483647)
    c_lo, c_hi = torch.full_like(lo, -1), torch.full_like(lo, -1)
    th, passes, full = lo.clone(), torch.zeros_like(lo), torch.zeros_like(lo)
    listed = torch.zeros_like(lo)
    done = torch.zeros(rows, dtype=torch.bool, device=slots.device)
    compact = torch.zeros_like(done)
    in_cand = torch.zeros_like(slots, dtype=torch.bool)
    shape = (rows,) + (1,) * (slots.dim() - 1)

    def b(t):  # a per-row value against the slots
        return t.view(shape)

    for _ in range(32):
        now = ~compact & ~done & (c_lo >= 0) & (c_hi >= 0) & (c_lo - c_hi <= cand)
        in_cand = torch.where(b(now), (slots >= b(lo)) & (slots < b(hi)), in_cand)
        compact |= now
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        ge = slots >= b(mid)
        total = total_of(torch.where(b(compact), ge & in_cand, ge))
        total = torch.where(compact, total + c_hi, total)
        live = ~done
        counts = live if top is None else live & ((passes <= 1) | (mid <= top))
        passes += live.int()
        full += (counts & ~compact).int()
        listed += (counts & compact).int()
        hit = live & (total == k)
        th = torch.where(hit, mid, th)
        up, down = live & (total > k), live & (total < k)
        lo, c_lo = torch.where(up, mid, lo), torch.where(up & ~compact, total, c_lo)
        hi, c_hi = torch.where(down, mid, hi), torch.where(down & ~compact, total, c_hi)
        done |= hit
    ncand = torch.where(compact, c_lo - c_hi, torch.zeros_like(lo))
    return torch.where(done, th, lo)[:, None], passes, full, ncand, listed


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
    # each thread's count, each warp's sum, then the CTA's
    th, passes, *_ = _bisect(slots, k, 0, lambda m: m.sum(dim=1).sum(dim=2).sum(dim=1))
    return x, th, passes


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
    th, passes, *_ = _bisect(slots, k, cand, lambda m: m.sum(dim=(1, 4)).sum(dim=2).sum(dim=1))
    return x, th, passes


def cluster_threshold(pre: torch.Tensor, k: int, ctas: int | None = None,
                      cand: int = _build.CLUSTER_CAND, stats: dict | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cluster select (``csrc/topk_common.cuh: cluster_kth_largest``)
    on each row of a 2-D ``pre``, transcribed: ``ctas`` CTAs
    (:func:`_build.cluster_ctas` of the width by default) hold the row,
    CTA r the slice [r*s, (r+1)*s), s = ceil(H / ctas) rounded up to 32
    (INT_MIN past the row); each pass sums each CTA's count, then the
    cluster's, and a row leaves the loop at the first pass whose total is
    exactly k, else after 32 passes at ``lo``.  Once passes have set both
    bounds and at most ``cand`` values lie in [lo, hi), those values are
    the candidates (the leader's list) and each later total is the total
    at hi then plus the candidates >= mid, as in :func:`group_threshold`.
    Passes 0 and 1 are one sweep (it counts at 0 and at both mids pass 1
    can take); a later pass whose mid lies above the row's largest value
    (the sweep's exchange brings it) has the total 0 on the whole row,
    c_hi on the list, with no count.  -> (x, th [rows, 1], passes
    [rows]), with ``stats``, if given, filled with ``full_passes`` (the
    passes that count over the whole row), ``candidates`` (the list's
    length, 0 where there was none) and ``list_passes`` (the passes that
    count on the list), each [rows].  The midpoints and totals are
    :func:`cta_threshold`'s, so the threshold, the pass count and the mask
    are too."""
    x = _monotone_int(pre)
    rows, h = x.shape
    c = ctas or _build.cluster_ctas(h)
    s = -(-h // c)
    s = -(-s // 32) * 32  # csrc/topk_common.cuh:cluster_slice
    slots = torch.full((rows, c * s), -2147483648, dtype=torch.int32, device=pre.device)
    slots[:, :h] = x
    slots = slots.view(rows, c, s)  # [row, CTA, slice element]
    th, passes, full, ncand, listed = _bisect(slots, k, cand, lambda m: m.sum(dim=2).sum(dim=1),
                                              x.max(dim=1).values)
    if stats is not None:
        stats.update(full_passes=full, candidates=ncand, list_passes=listed)
    return x, th, passes


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu``: max(x, 0), with +0.0 for -0.0 (``torch.relu``
    keeps the sign of a -0.0; adding +0.0 clears it and nothing else)."""
    return torch.relu(x) + 0.0


def topk_mask_plain(pre: torch.Tensor, k: int) -> torch.Tensor:
    """relu(pre) where pre is among the row's k largest, else +0.0."""
    x, th = topk_threshold(pre, k)
    return torch.where(x >= th, relu(pre), torch.zeros((), dtype=pre.dtype, device=pre.device))


def topk_mask_dense(pre: torch.Tensor, k: int) -> torch.Tensor:
    """Dense top-k activation with the straight-through-the-selection
    gradient ``g * [hidden > 0]``: kernel C for a CUDA tensor, the plain
    version above for a CPU tensor."""
    from .cuda_topk import topk_mask

    return topk_mask(pre, k)


# ---------------------------------------------------------------------------
# the (vals, idx) sparse form (``ops/topk.py:92-160`` of the JAX package:
# ``jax.lax.top_k`` and an einsum there, no Pallas kernel, so plain PyTorch
# on either device here)
# ---------------------------------------------------------------------------


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """int64 keys of the last axis that rank as ``jax.lax.top_k`` does: by
    value, descending, -0.0 below +0.0 (the f32 total order), then by the
    lower index."""
    mono = _monotone_int(values.float()).to(torch.int64)
    idx = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    return mono * (1 << 32) + ((1 << 32) - 1 - idx)


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, indices), descending,
    ties to the lower index."""
    idx = torch.topk(_order_keys(values), k, dim=-1).indices
    return torch.gather(values, -1, idx), idx


def topk_select(pre: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest pre-activations of each row, relu'd: (vals [..., k]
    descending, idx [..., k] int64 into the feature axis)."""
    vals, idx = top_k(pre, k)
    return relu(vals), idx


def scatter_topk(vals: torch.Tensor, idx: torch.Tensor, hidden_dim: int) -> torch.Tensor:
    """Scatter [..., k] (vals, idx) into a dense [..., hidden_dim] tensor."""
    dense = torch.zeros(*vals.shape[:-1], hidden_dim, dtype=vals.dtype, device=vals.device)
    return dense.scatter_(-1, idx.long(), vals)


def sparse_decode(vals: torch.Tensor, idx: torch.Tensor, w_dec: torch.Tensor,
                  b_dec: torch.Tensor) -> torch.Tensor:
    """Reconstruction from the k active latents only: [B, D] =
    sum_k vals[:, k] * w_dec[idx[:, k]] + b_dec, the values cast to
    ``w_dec``'s dtype and summed in f32 (TF32 off)."""
    from ..utils.device import f32_matmuls

    rows = w_dec[idx]  # [B, k, D]
    with f32_matmuls():
        recon = torch.bmm(vals.to(rows.dtype).float()[:, None, :], rows.float())[:, 0]
    return recon + b_dec


def topk_encode(x: torch.Tensor, w_enc: torch.Tensor, b_enc: torch.Tensor,
                b_pre: torch.Tensor | None, k: int, compute_dtype=torch.float32
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centre, encode and select: (vals [B, k] relu'd, idx [B, k]).  The
    product takes its operands in ``compute_dtype`` and sums in f32 (TF32
    off); the selection is in f32."""
    from ..utils.device import mm_f32

    xc = x - b_pre if b_pre is not None else x
    pre = mm_f32(xc.to(compute_dtype), w_enc.to(compute_dtype)) + b_enc
    return topk_select(pre, k)
