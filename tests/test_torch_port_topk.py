"""The port's exact top-k mask against the JAX package's.

Kernel C's plain version (``whisper_sae_tpu_torch.ops.topk``) must select
exactly what ``whisper_sae_tpu.ops.topk.topk_mask_dense`` and the Pallas
kernel ``topk_mask_pallas`` (interpret mode) select, bit for bit,
including rows with many exact ties, and its VJP must match too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_topk
from whisper_sae_tpu.ops import topk as jtopk
from whisper_sae_tpu_torch.ops import topk as ttopk
from whisper_sae_tpu_torch.ops.cuda_topk import topk_mask, topk_mask_fwd

B, H = 64, 512


def _pre(seed: int, ties: bool, h: int = H) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((B, h)).astype(np.float32)
    if ties:
        # coarse grid: every row has many exact ties at its threshold,
        # and some rows are all equal or all negative
        pre = np.round(pre * 2) / 2
        pre[0] = 0.25
        pre[1] = -np.abs(pre[1]) - 1
    return pre


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("ties", [False, True])
def test_mask_bit_identical_to_jax(k, ties):
    pre = _pre(k, ties)
    want = jtopk.topk_mask_dense(jnp.asarray(pre), k)
    got = ttopk.topk_mask_dense(torch.from_numpy(pre), k)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ties", [False, True])
def test_threshold_bit_identical_to_jax(ties):
    pre = _pre(7, ties)
    jx, jth = jtopk.topk_threshold(jnp.asarray(pre), 8)
    tx, tth = ttopk.topk_threshold(torch.from_numpy(pre), 8)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tth.numpy(), np.asarray(jth))


def test_ties_admit_more_than_k():
    pre = _pre(3, ties=True)
    hidden = ttopk.topk_mask_plain(torch.from_numpy(pre), 8)
    x, th = ttopk.topk_threshold(torch.from_numpy(pre), 8)
    counts = (x >= th).sum(dim=1)
    assert (counts >= 8).all() and (counts > 8).any()
    assert int((hidden[1] > 0).sum()) == 0  # all-negative row: relu after selection


@pytest.mark.parametrize("ties", [False, True])
def test_plain_kernel_c_matches_pallas_interpret(ties):
    pre = _pre(11, ties)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_topk.topk_mask_pallas(jnp.asarray(pre), 8, 8)
    got = topk_mask_fwd(torch.from_numpy(pre), 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_vjp_matches_pallas_interpret():
    pre = _pre(5, ties=True)
    g = np.random.default_rng(6).standard_normal((B, H)).astype(np.float32)

    def f(p):
        with pltpu.force_tpu_interpret_mode():
            return pallas_topk.topk_mask_pallas(p, 8, 8)

    _, vjp = jax.vjp(f, jnp.asarray(pre))
    (want,) = vjp(jnp.asarray(g))
    p = torch.tensor(pre, requires_grad=True)
    topk_mask(p, 8).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(p.grad), _bits(want))


def _monotone(pre: np.ndarray) -> np.ndarray:
    x = pre.view(np.int32)
    return np.where(x < 0, x ^ 0x7FFFFFFF, x)


def _warp_threshold(xi: np.ndarray, k: int) -> tuple[int, int]:
    """The pass loop of ``csrc/topk_common.cuh:warp_kth_largest`` on one
    row, transcribed: lane l holds elements j*32 + l (INT_MIN past the
    row), each pass counts per lane and sums the lanes once, and the loop
    stops at a count of exactly k.  -> (threshold, passes run)."""
    lanes = np.full(-(-xi.size // 32) * 32, np.iinfo(np.int32).min, np.int64)
    lanes[:xi.size] = xi
    lanes = lanes.reshape(-1, 32)  # [j, lane]
    lo, hi = -2147483647, 2147483647
    for p in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = int((lanes >= mid).sum(axis=0).sum())  # per-lane counts, then one reduction
        if cnt == k:
            return mid, p + 1
        if cnt > k:
            lo = mid
        else:
            hi = mid
    return lo, 32


def _cta_threshold(xi: np.ndarray, k: int, threads: int = 512) -> tuple[int, int]:
    """The pass loop of ``csrc/topk_common.cuh:cta_kth_largest`` on one
    row, transcribed: thread t of the CTA's 512 holds elements j*512 + t
    (INT_MIN past the row); each pass counts per thread, sums each warp's
    32 lanes, then every thread sums the 16 warp counts, and the loop
    stops at a total of exactly k.  -> (threshold, passes run)."""
    slots = np.full(-(-xi.size // threads) * threads, np.iinfo(np.int32).min, np.int64)
    slots[:xi.size] = xi
    slots = slots.reshape(-1, threads // 32, 32)  # [j, warp, lane]
    lo, hi = -2147483647, 2147483647
    for p in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        per_thread = (slots >= mid).sum(axis=0)  # [warp, lane]
        total = int(per_thread.sum(axis=1).sum())  # each warp's sum, then the CTA's
        if total == k:
            return mid, p + 1
        if total > k:
            lo = mid
        else:
            hi = mid
    return lo, 32


WIDE_H = 40960  # whisper-large 32x: the CTA-per-row form
SELECT_CASES = [pytest.param(_warp_threshold, H, k, ties, id=f"{ties}-{k}")
                for k in (1, 32, H) for ties in (False, True)] + [
               pytest.param(_cta_threshold, WIDE_H, k, ties, id=f"cta-{ties}-{k}")
               for k in (1, 32, WIDE_H) for ties in (False, True)]


@pytest.mark.parametrize("select,h,k,ties", SELECT_CASES)
def test_kernel_select_early_exit_bit_identical_to_jax(select, h, k, ties):
    """The kernels' select, in its warp form (a row of H = 512 in one
    warp) and its CTA form (H = 40960 across 512 threads), stops at the
    first midpoint that counts exactly k.  Its threshold may differ from
    the full bisection's, but any threshold in (v_{k+1}, v_k] selects the
    same entries, and under a tie at v_k no midpoint counts k: the mask
    is the JAX package's, bit for bit, and every row without ties leaves
    the loop before its 32nd pass."""
    pre = _pre(100 + k, ties, h)
    want = np.asarray(jtopk.topk_mask_dense(jnp.asarray(pre), k))
    xi = _monotone(pre)
    got = np.zeros_like(pre)
    passes = []
    for r in range(B):
        th, n = select(xi[r], k)
        got[r] = np.where(xi[r] >= th, np.maximum(pre[r], 0.0), 0.0)
        passes.append(n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if not ties:
        assert max(passes) < 32


@pytest.mark.parametrize("ties", [False, True])
def test_cta_threshold_matches_the_pass_loop(ties):
    """``ops.topk.cta_threshold`` (the select as the blocked route's plain
    transcription and the smoke run's bound count it, rows at once) gives
    each row the threshold and the pass count of the one-row loop above."""
    pre = _pre(7, ties, WIDE_H)[:16]
    x, th, passes = ttopk.cta_threshold(torch.from_numpy(pre), 32)
    for r in range(pre.shape[0]):
        assert (int(th[r, 0]), int(passes[r])) == _cta_threshold(_monotone(pre)[r], 32)
    np.testing.assert_array_equal(x.numpy(), _monotone(pre))


def test_cpu_dispatch_counts_no_launch():
    before = topk_mask_fwd.launches
    topk_mask_fwd(torch.from_numpy(_pre(1, False)), 4)
    assert topk_mask_fwd.launches == before
