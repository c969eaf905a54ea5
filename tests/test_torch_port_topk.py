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


def _pre(seed: int, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((B, H)).astype(np.float32)
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


def test_cpu_dispatch_counts_no_launch():
    before = topk_mask_fwd.launches
    topk_mask_fwd(torch.from_numpy(_pre(1, False)), 4)
    assert topk_mask_fwd.launches == before
