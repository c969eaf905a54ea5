"""The wide routes' group form on the CPU, against the JAX package.

Past the warp select (H > 3072) kernel A's wide route and the coder's TopK
modes select and decode with ``csrc/select_decode.cuh:group_select_decode``
up to H = 8192 (``_build.wide_form``): a warp group of 128 threads a row,
thread t holding the runs of four values q*512 + 4t + i, the bisection's
passes counted per thread, per warp, then per group, stopping at a count
of exactly k.  Its plain model, ``ops.topk.group_threshold``, is held here
bit for bit against the JAX package's ``topk_threshold`` mask and
``topk_mask_dense`` latent from numpy-seeded rows at H = 4096, 6144 and
8192 (and at 24576, where the dispatch names the CTA-per-row form, its
model ``cta_threshold``), k = 1, 32, 64, and on the edge cases: exact ties
at the k-th value, all-negative rows, fewer than k positives, +0.0 and
-0.0, k = H.  Its passes and threshold are ``cta_threshold``'s.

The group form sums each row's squares in its own order (its threads'
column pairs, a butterfly over each warp, the warps in order: one
partial a row).  The routes written out in that order, kernel A's
``cuda_sae.fused_loss_wide_route_plain`` and the coder's
``coder_topk_route_plain(..., per_row=True)``, are held against the JAX
package's fused loss and fused coder forward in interpret mode at D = 64
to 128, H = 4096 and 4160 (a row ending inside a thread's run column), at
a row offset and on row counts that are not a multiple of a CTA's rows.

Tolerances (those of ``tests/test_torch_port_wide_loss.py`` and
``tests/test_torch_port_coder_wide.py``): masks and latents bit for bit;
the loss at rtol 1e-5, l0 and the any-active vector exactly, the residual
and the bf16 latent within bf16 rounding of the JAX kernel's (atol 1e-2 *
max), and against the port's plain version the latent bit for bit, the
residual at atol 1e-5 * max (f32 sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu.ops import topk as jtopk
from whisper_sae_tpu_torch.ops import _build, cuda_coder, cuda_sae
from whisper_sae_tpu_torch.ops import topk as ttopk


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _model(h: int):
    """The select the wide routes run at width ``h``: the group form's up to
    ``_build.MAX_GROUP_ROW``, else the CTA-per-row form's."""
    return ttopk.group_threshold if _build.wide_form(h) == "group" else ttopk.cta_threshold


def _check_select(pre: np.ndarray, k: int) -> None:
    """The model's mask on ``pre`` bit for bit against the JAX package's
    ``topk_threshold`` mask, and its latent (and the plain top-k's) against
    ``topk_mask_dense``'s bit for bit, the sign of a selected -0.0
    included (+0.0, as ``jax.nn.relu`` gives)."""
    jx, jth = jtopk.topk_threshold(jnp.asarray(pre), k)
    want_mask = np.asarray(jx >= jth)
    want_latent = np.asarray(jtopk.topk_mask_dense(jnp.asarray(pre), k))
    t = torch.from_numpy(pre)
    x, th, _ = _model(pre.shape[1])(t, k)
    mask = x >= th
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    latent = torch.where(mask, ttopk.relu(t), torch.zeros(())).numpy()
    np.testing.assert_array_equal(_bits(latent), _bits(want_latent))
    np.testing.assert_array_equal(_bits(ttopk.topk_mask_plain(t, k).numpy()), _bits(want_latent))


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("h", [4096, 6144, 8192, 24576])
def test_select_mask_bit_identical_to_jax(h, k):
    rng = np.random.default_rng(h + k)
    pre = (rng.standard_normal((6, h)) * rng.uniform(0.05, 3.0, (6, 1))).astype(np.float32)
    _check_select(pre, k)


def _edge_rows(case: str, h: int) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(len(case) + h)
    pre = rng.standard_normal((4, h)).astype(np.float32)
    k = 32
    if case == "ties":  # a coarse grid: many exact ties at each row's k-th value
        pre = np.round(pre * 2) / 2
        pre[0, :40] = pre[0].max()  # more than k tied at the top
    elif case == "all_negative":
        pre = -np.abs(pre) - 1
    elif case == "few_positive":  # 5 positives, the rest negative
        pre = -np.abs(pre)
        pre[:, rng.choice(h, 5, replace=False)] = 0.5
    elif case == "signed_zero":  # few positives, then +0.0 and -0.0 straddle the k-th
        pre = np.where(rng.random((4, h)) < 0.5, np.float32(0.0), np.float32(-0.0))
        pre[:, rng.choice(h, 20, replace=False)] = 1.0
        pre[1] = -0.0
        pre[2, : h // 2] = -np.abs(pre[2, : h // 2]) - 2
    elif case == "k_equals_h":
        k = h
    return pre.astype(np.float32), k


EDGES = ["ties", "all_negative", "few_positive", "signed_zero", "k_equals_h"]


@pytest.mark.parametrize("h", [4160, 6144])
@pytest.mark.parametrize("case", EDGES)
def test_select_edge_cases_bit_identical_to_jax(case, h):
    pre, k = _edge_rows(case, h)
    _check_select(pre, k)
    if case == "signed_zero":  # -0.0 sorts below +0.0 in the monotone view, and is selected
        assert bool((ttopk._monotone_int(torch.tensor([-0.0])) < 0).all())
        assert np.signbit(pre).any() and not np.signbit(
            ttopk.topk_mask_plain(torch.from_numpy(pre), k).numpy()).any()


@pytest.mark.parametrize("case", ["gaussian", *EDGES])
def test_group_threshold_is_the_cta_select(case):
    """The group form's midpoints and totals are the CTA form's: the same
    threshold and pass count on every row (only the thread layout of the
    counts differs)."""
    if case == "gaussian":
        pre, k = np.random.default_rng(3).standard_normal((8, 6144)).astype(np.float32), 32
    else:
        pre, k = _edge_rows(case, 6144)
    t = torch.from_numpy(pre)
    _, gth, gpasses = ttopk.group_threshold(t, k)
    _, cth, cpasses = ttopk.cta_threshold(t, k)
    assert torch.equal(gth, cth) and torch.equal(gpasses, cpasses)
    assert int(gpasses.max()) <= 32


def test_group_threshold_refuses_wider_rows():
    with pytest.raises(ValueError, match="at most 8192"):
        ttopk.group_threshold(torch.zeros(1, 8224), 1)


# ---------------------------------------------------------------------------
# the routes in the group form's order against the JAX kernels, interpret mode
# ---------------------------------------------------------------------------

BLOCK = 4
# (D, H, k): N = 32 values a thread; 48 with the row ending inside a run column
ROUTE_GEOMS = [(128, 4096, 32), (96, 4160, 16), (64, 4160, 64)]
ROUTE_IDS = ["d128_h4096", "d96_h4160", "d64_h4160_k64"]


def _params(seed: int, d: int, h: int, dout: int | None = None) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dout = d if dout is None else dout
    return {
        "w_enc": (rng.standard_normal((d, h)) / np.sqrt(d)).astype(np.float32),
        "b_enc": (rng.standard_normal(h) * 0.05).astype(np.float32),
        "b_pre": (rng.standard_normal(d) * 0.05).astype(np.float32),
        "w_dec": (rng.standard_normal((h, dout)) * 0.2).astype(np.float32),
        "b_dec": (rng.standard_normal(dout) * 0.05).astype(np.float32),
        "w_skip": (rng.standard_normal((d, dout)) * 0.05).astype(np.float32),
    }


def _within_bf16(got: torch.Tensor, want) -> None:
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0, atol=1e-2 * float(np.abs(w).max()))


@pytest.mark.parametrize("step,rows", [(0, 44), (2, 36)])
@pytest.mark.parametrize("d,h,k", ROUTE_GEOMS, ids=ROUTE_IDS)
def test_kernel_a_group_route_matches_pallas_interpret(d, h, k, step, rows):
    """Kernel A's wide route in the group form's order, on the window
    [step * rows, (step + 1) * rows) of a buffer, against the JAX fused loss
    (``fused_sae_loss_indexed``, interpret mode) and the port's plain
    version."""
    assert _build.wide_form(h) == "group" and cuda_sae.fused_loss_supported(d, h)
    p = _params(d + h + rows, d, h)
    buf = np.random.default_rng(d + h + step).standard_normal((3 * rows, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        loss, l0, active = ps.fused_sae_loss_indexed(
            jnp.asarray(buf), jnp.int32(step), *(jnp.asarray(p[n]) for n in
                                                 ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")),
            k, BLOCK, rows)
    t = {n: torch.from_numpy(v) for n, v in p.items()}
    we_t, wd = cuda_sae._bf16_t(t["w_enc"]), t["w_dec"].bfloat16()
    b_out = t["b_dec"] + t["b_pre"]
    x = torch.from_numpy(buf)
    got = cuda_sae.fused_loss_wide_route_plain(x, step * rows, rows, we_t, t["b_enc"], t["b_pre"],
                                               wd, b_out, k)
    np.testing.assert_allclose(float(got[0]), float(loss), rtol=1e-5)
    assert float(got[1]) == float(l0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(active))
    win = x[step * rows:(step + 1) * rows]
    plain = cuda_sae.fused_sae_loss_plain(win, we_t, t["b_enc"], t["b_pre"], wd, b_out, k)
    assert torch.equal(got[3], plain[3]) and torch.equal(got[5], plain[5])
    torch.testing.assert_close(got[4], plain[4], rtol=0, atol=1e-5 * float(plain[4].abs().max()))
    torch.testing.assert_close(got[0], plain[0], rtol=1e-5, atol=0)


CODER_MODES = {  # mode: (skip, y is x)
    "skip_transcoder": (True, False), "topk_transcoder": (False, False),
    "topk_crosscoder": (False, True),
}


@pytest.mark.parametrize("mode", list(CODER_MODES))
@pytest.mark.parametrize("d,h,k", ROUTE_GEOMS[:2], ids=ROUTE_IDS[:2])
def test_coder_group_route_matches_pallas_interpret(d, h, k, mode):
    """The coder's TopK modes in the group form's order
    (``coder_topk_route_plain(..., per_row=True)``) at a row offset, on 36
    rows, against the JAX fused coder forward in interpret mode (the
    crosscoder on its flattened view: its rows are their own target)."""
    skip, y_is_x = CODER_MODES[mode]
    p = _params(d + h + len(mode), d, h)
    rng = np.random.default_rng(h + len(mode))
    rows, off = 36, 5
    xn = rng.standard_normal((rows + 2 * off, d)).astype(np.float32)
    yn = xn if y_is_x else rng.standard_normal((rows + 2 * off, d)).astype(np.float32)
    zero = jnp.zeros((), jnp.float32)
    win = slice(off, off + rows)
    xj = jnp.asarray(xn[win])
    with pltpu.force_tpu_interpret_mode():
        outs = ps.fused_transcoder_loss(
            xj, xj if y_is_x else jnp.asarray(yn[win]), jnp.asarray(p["w_enc"]),
            jnp.asarray(p["b_enc"]), jnp.asarray(p["w_dec"]), jnp.asarray(p["b_dec"]),
            jnp.asarray(p["w_skip"]) if skip else zero, zero, k, BLOCK, skip, y_is_x)
    t = {n: torch.from_numpy(v) for n, v in p.items()}
    ops = cuda_coder.operands(t["w_enc"], t["b_enc"], t["w_dec"], t["b_dec"],
                              t["w_skip"] if skip else None, topk=True)
    got = cuda_coder.coder_topk_route_plain(torch.from_numpy(xn), None if y_is_x else
                                            torch.from_numpy(yn), off, rows, ops, k, 32,
                                            per_row=True)
    np.testing.assert_allclose(float(got.sq) / (rows * d), float(outs[0]), rtol=1e-5)
    assert float(np.float32(int(got.l0)) / np.float32(rows)) == float(outs[1])
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(outs[2]))
    _within_bf16(got.resid, outs[3])
    _within_bf16(got.hid, np.asarray(outs[4].astype(jnp.float32)))


def test_group_row_sq_sums_each_row():
    """The group form's order of a row's squares is a sum of those squares:
    within f32 rounding of the f64 sum, on widths that fill one decode
    pass, leave threads idle (dout = 96) and take two (dout = 1536)."""
    rng = np.random.default_rng(7)
    for dout in (96, 768, 1536):
        r = torch.from_numpy(rng.standard_normal((5, dout)).astype(np.float32))
        got = cuda_sae.group_row_sq(r)
        want = (r.double() ** 2).sum(dim=1)
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
