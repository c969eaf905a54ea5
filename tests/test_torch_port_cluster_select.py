"""The top-k encode's cluster select (past H = 40960) on the CPU, against the
JAX package.

Past a CTA's registers (H > 40960: whisper-tiny 128x, whisper-large 64x,
kernel C up to 262,144, the blocked encode up to 2^20) the port selects
with ``csrc/blocked_encode.cu:cluster_select_kernel``: a thread-block
cluster of 2, 4 or 8 CTAs holds a row (``_build.cluster_ctas``), each
pass sums the CTAs' counts over distributed shared memory, and once at
most ``_build.CLUSTER_CAND`` values lie between the bounds the CTAs
compact them into one list and finish the passes on it.  Its plain model,
``ops.topk.cluster_threshold``, is held here from numpy-seeded rows:

  - its mask bit for bit against the JAX package's ``topk_threshold``
    mask, its latent (and the plain top-k's) against ``topk_mask_dense``,
    the sign of a selected -0.0 included, at H = 49152, 81920, 262,144 and
    655,392 (past 8 slices of 40960: each slice's rest read again each
    pass), k = 1, 32, 64, and on the edge rows: exact ties at the k-th
    value (more than the candidate cap of them too), all-equal rows,
    all-negative rows, fewer than k positives, +0.0 and -0.0, k = H;
  - its threshold and pass count equal to ``cta_threshold``'s, whatever
    the candidate cap (the compaction changes neither), the compaction
    taking place on gaussian rows with at most the cap of candidates;
  - the dispatch: the cluster's CTAs by width, and the form past 40960;
  - the blocked route at whisper-large 64x's width (H = 81920, D = 64)
    against ``pallas_sae._encode_forward_blocked`` in interpret mode:
    selection identical, the bf16 latent bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_wide_select import EDGES, _bits, _edge_rows

from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu.ops import topk as jtopk
from whisper_sae_tpu_torch.ops import _build, cuda_sae
from whisper_sae_tpu_torch.ops import topk as ttopk

WIDTHS = [49152, 81920, 262144, 655392]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(pre: np.ndarray, k: int) -> dict:
    """The cluster model on ``pre`` against the JAX package's mask and
    latent bit for bit, and against ``cta_threshold``'s threshold and pass
    count.  Returns the model's stats."""
    jx, jth = jtopk.topk_threshold(jnp.asarray(pre), k)
    want_latent = np.asarray(jtopk.topk_mask_dense(jnp.asarray(pre), k))
    t = torch.from_numpy(pre)
    stats: dict = {}
    x, th, passes = ttopk.cluster_threshold(t, k, stats=stats)
    mask = x >= th
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jx >= jth))
    latent = torch.where(mask, ttopk.relu(t), torch.zeros(())).numpy()
    np.testing.assert_array_equal(_bits(latent), _bits(want_latent))
    np.testing.assert_array_equal(_bits(ttopk.topk_mask_plain(t, k).numpy()), _bits(want_latent))
    _, cth, cpasses = ttopk.cta_threshold(t, k)
    assert torch.equal(th, cth) and torch.equal(passes, cpasses)
    assert bool((stats["candidates"] <= _build.CLUSTER_CAND).all())
    assert bool((stats["full_passes"] <= passes).all())
    return stats


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("h", WIDTHS)
def test_cluster_select_matches_jax(h, k):
    rng = np.random.default_rng(h + k)
    rows = 2 if h > 300000 else 4
    pre = (rng.standard_normal((rows, h)) * rng.uniform(0.05, 3.0, (rows, 1))).astype(np.float32)
    assert _build.select_form(h) == "cluster"
    stats = _check(pre, k)
    # gaussian rows compact: a few passes over the whole row, the rest on the list
    assert bool((stats["candidates"] > 0).all())
    assert int(stats["full_passes"].max()) <= 12


def _cluster_edge_rows(case: str, h: int) -> tuple[np.ndarray, int]:
    if case == "ties_past_cap":  # more than the cap tied at the k-th value
        pre = np.random.default_rng(h).standard_normal((3, h)).astype(np.float32)
        pre[0, :10000] = pre[0].max()
        pre[1, 5000:5000 + 2 * _build.CLUSTER_CAND] = 2.0
        pre[2, ::3] = 1.0
        return pre, 32
    if case == "all_equal":
        pre = np.full((2, h), 1.5, np.float32)
        pre[1] = -0.0
        return pre, 32
    return _edge_rows(case, h)


@pytest.mark.parametrize("h", [49152, 262144])
@pytest.mark.parametrize("case", [*EDGES, "ties_past_cap", "all_equal"])
def test_cluster_select_edge_rows_match_jax(case, h):
    pre, k = _cluster_edge_rows(case, h)
    stats = _check(pre, k)
    if case in ("ties_past_cap", "all_equal"):  # no compaction past the cap
        assert int(stats["candidates"][0]) == 0


@pytest.mark.parametrize("cand", [0, 256, _build.CLUSTER_CAND, 1 << 20])
def test_candidate_cap_changes_neither_threshold_nor_passes(cand):
    rng = np.random.default_rng(5)
    pre = torch.from_numpy(rng.standard_normal((6, 81920)).astype(np.float32))
    pre[0] = torch.round(pre[0] * 2) / 2
    _, th, passes = ttopk.cluster_threshold(pre, 32, cand=cand)
    _, cth, cpasses = ttopk.cta_threshold(pre, 32)
    assert torch.equal(th, cth) and torch.equal(passes, cpasses)


@pytest.mark.parametrize("ctas", [2, 4, 8])
def test_slices_change_nothing(ctas):
    """The model's threshold is the same whatever the cluster's size: the
    counts are integer sums over the slices."""
    rng = np.random.default_rng(ctas)
    pre = torch.from_numpy(rng.standard_normal((4, 98304)).astype(np.float32))
    _, th, passes = ttopk.cluster_threshold(pre, 32, ctas=ctas)
    _, cth, cpasses = ttopk.cta_threshold(pre, 32)
    assert torch.equal(th, cth) and torch.equal(passes, cpasses)


@pytest.mark.parametrize("h,ctas", [(40992, 2), (49152, 2), (81920, 2), (81952, 4),
                                    (163840, 4), (163872, 8), (262144, 8), (1 << 20, 8)])
def test_cluster_ctas_by_width(h, ctas):
    assert _build.select_form(h) == _build.wide_form(h) == "cluster"
    assert _build.cluster_ctas(h) == ctas
    # the slices hold the row on chip up to 8 CTAs of CLUSTER_SLICE values
    assert (h <= ctas * _build.CLUSTER_SLICE) or ctas == 8


@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_blocked_route_at_large_64x_width_matches_pallas_interpret(out):
    """The encode's route (its chunk, and ragged chunks of 8) with the
    cluster model against ``_encode_forward_blocked`` in interpret mode at
    H = 81920 (whisper-large 64x's width), D = 64."""
    d, h, rows, k = 64, 81920, 12, 32
    rng = np.random.default_rng(81)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w_enc = (rng.standard_normal((d, h)) * 0.2).astype(np.float32)
    b_enc = (rng.standard_normal(h) * 0.05).astype(np.float32)
    b_pre = (rng.standard_normal(d) * 0.05).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want = ps._encode_forward_blocked(jnp.asarray(x), jnp.asarray(w_enc).astype(jnp.bfloat16),
                                          jnp.asarray(b_enc), jnp.asarray(b_pre), k, 8, jdt)
    want = np.asarray(want.astype(jnp.float32))
    tw = torch.from_numpy(w_enc)
    args = (torch.from_numpy(x), cuda_sae._bf16_t(tw), torch.from_numpy(b_enc),
            torch.from_numpy(b_pre), k, tdt)
    for got in (cuda_sae.topk_encode_route_plain(*args), cuda_sae.topk_encode_route_plain(*args, 8)):
        assert got.dtype == tdt and got.shape == (rows, h)
        got = got.float().numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        assert ((got > 0).sum(axis=1) == k).all()
        if out == "bf16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
