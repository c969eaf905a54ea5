"""The coder kernel's TopK route written out in plain PyTorch
(``cuda_coder.coder_topk_route_plain``: the kPre encode, the skip base,
the exact top-k, the sparse decode in feature order in passes of output
columns, one sum-of-squares partial a CTA of rows and the fixed-order sum)
against the JAX package's Pallas coder kernel in interpret mode, as
``tests/test_pallas_interpret.py`` runs it, and against
``coder_forward_plain``, at the geometry of
``test_torch_port_coder_ops.py`` (D=128, H=256, K=8; the crosscoder as
L=2 layers of 64).

The three TopK modes, sliced, at a row offset into an epoch buffer (the
indexed entry) and on a ragged window (not a whole number of the select's
4-row CTAs), for f32 and bf16 rows.  The decode runs in passes of 96
columns, so every mode's 128 output columns take two passes, the second
a partial one.  Bars against the JAX kernel: the loss at rtol 1e-5, l0
and the active vector exactly, the residual and the latent within bf16
rounding (atol 1e-2 * max).  Against ``coder_forward_plain``: the bf16
rows, the latent, l0 and active bit-equal (the same encode and mask), the
residual within f32 sum order (atol 1e-5 * max) and the sum of squares at
rtol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu_torch.ops import cuda_coder as cc

B, D, H, K = 32, 128, 256, 8
PASS_COLS = 96  # below dout = 128: two decode passes, the second partial
MODES = ("skip_transcoder", "topk_transcoder", "topk_crosscoder")
WINDOWS = {  # case: (buffer rows, row offset, rows, the JAX kernel's block rows)
    "sliced": (B, 0, B, 8),
    "offset": (3 * B, 2 * B, B, 8),
    "ragged": (3 * B, 37, 42, 21),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(mode: str, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    p = {
        "w_enc": rng.standard_normal((D, H)) * 0.2,
        "b_enc": rng.standard_normal(H) * 0.05,
        "w_dec": rng.standard_normal((H, D)) * 0.2,
        "b_dec": rng.standard_normal(D) * 0.05,
    }
    if mode == "skip_transcoder":
        p["w_skip"] = rng.standard_normal((D, D)) * 0.1
        p["b_skip"] = rng.standard_normal(D) * 0.05
    return {k: v.astype(np.float32) for k, v in p.items()}


def _jax_forward(mode, p, xbuf, ybuf, case):
    """(loss, l0, active, resid, hid) of the JAX kernel on the window:
    ``_fused_coder_forward_indexed`` for the offset case, else
    ``_fused_coder_forward`` on the window's rows."""
    _, off, rows, block = WINDOWS[case]
    skip = mode == "skip_transcoder"
    y_is_x = mode == "topk_crosscoder"
    zero = jnp.zeros((), jnp.float32)
    w = (p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"], p.get("w_skip", zero),
         p.get("b_skip", zero))
    w = tuple(jnp.asarray(v) for v in w)
    with pltpu.force_tpu_interpret_mode():
        if case == "offset":
            yb = xbuf if y_is_x else ybuf
            loss, l0, active, hid, resid, *_ = ps._fused_coder_indexed_impl(
                xbuf, yb, jnp.int32(off // rows), *w, K, block, rows, skip, y_is_x)
            return loss, l0, active, resid, hid
        x = xbuf[off:off + rows]
        y = x if y_is_x else ybuf[off:off + rows]
        loss, l0, active, resid, hid, *_ = ps._fused_coder_impl(x, y, *w, K, block, skip, y_is_x)
        return loss, l0, active, resid, hid


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(WINDOWS))
@pytest.mark.parametrize("mode", MODES)
def test_topk_route_matches_pallas_interpret_and_plain(mode, case, x_dtype):
    p = _params(mode, 60 + MODES.index(mode))
    n, off, rows, _ = WINDOWS[case]
    rng = np.random.default_rng(61)
    xbuf = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(x_dtype)
    ybuf = (None if mode == "topk_crosscoder"
            else torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(x_dtype))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    skip = mode == "skip_transcoder"
    b_out = t["b_dec"] + t["b_skip"] if skip else t["b_dec"]
    ops = cc.operands(t["w_enc"], t["b_enc"], t["w_dec"], b_out, t.get("w_skip"), topk=True)
    got = cc.coder_topk_route_plain(xbuf, ybuf, off, rows, ops, K, PASS_COLS)

    win = slice(off, off + rows)
    plain = cc.coder_forward_plain(xbuf[win], None if ybuf is None else ybuf[win], ops, K)
    assert torch.equal(got.xc, plain.xc) and torch.equal(got.hid, plain.hid)
    assert int(got.l0) == int(plain.l0) and torch.equal(got.active, plain.active)
    torch.testing.assert_close(got.resid, plain.resid, rtol=0,
                               atol=1e-5 * float(plain.resid.abs().max()))
    torch.testing.assert_close(got.sq, plain.sq, rtol=1e-5, atol=0)

    jdt = jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(xbuf.float().numpy()).astype(jdt)
    yj = None if ybuf is None else jnp.asarray(ybuf.float().numpy()).astype(jdt)
    loss, l0, active, resid, hid = _jax_forward(mode, p, xj, yj, case)
    np.testing.assert_allclose(float(got.sq) / (rows * D), float(loss), rtol=1e-5)
    assert float(np.float32(int(got.l0)) / np.float32(rows)) == float(l0)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(active))
    for mine, want in ((got.resid, resid), (got.hid.float(), hid.astype(jnp.float32))):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_topk_route_passes_change_no_bits():
    """The decode's passes split the output columns and nothing else: one
    pass, passes of 32 and of 96 give the same bits."""
    p = {k: torch.from_numpy(v) for k, v in _params("topk_crosscoder", 62).items()}
    ops = cc.operands(p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"], topk=True)
    x = torch.from_numpy(np.random.default_rng(63).standard_normal((50, D)).astype(np.float32))
    outs = [cc.coder_topk_route_plain(x, None, 3, 45, ops, K, cols) for cols in (D, 32, 96)]
    for o in outs[1:]:
        assert torch.equal(o.resid, outs[0].resid) and torch.equal(o.sq, outs[0].sq)


def test_operands_build_one_w_dec_copy_for_the_mode():
    p = {k: torch.from_numpy(v) for k, v in _params("skip_transcoder", 64).items()}
    topk = cc.operands(p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"], p["w_skip"], topk=True)
    relu = cc.operands(p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"])
    assert topk.wd_t is None and topk.wd.shape == (H, D) and topk.wd.dtype == torch.bfloat16
    assert relu.wd is None and relu.wd_t.shape == (D, H) and relu.wd_t.is_contiguous()
    assert torch.equal(topk.w_dec(), relu.w_dec())
