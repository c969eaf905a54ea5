"""Plain versions of the coder kernel against the JAX package's Pallas coder
kernels, run in interpret mode as ``tests/test_pallas_interpret.py`` runs
them, at that file's geometry (B=32, D=128, H=256, K=8; the crosscoder as
L=2 layers of 64).

Each of the five modes goes through its ``autograd.Function`` on the CPU,
sliced and at a row offset into a 3-batch buffer, against the JAX entry.
Tolerances: loss, recon and sparsity at rtol 1e-5 (the bar of
test_pallas_interpret.py); l0 and the any-active vector exactly; the
residual, the bf16 latent and the per-feature hidden sums within bf16
rounding (atol 1e-2 * max); every gradient at rtol 1e-2 (bf16 products
summed in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu_torch.ops import cuda_coder as cc

B, D, H, K = 32, 128, 256, 8
L = 2
BLOCK = 8
SW = 0.01
MODES = ("skip_transcoder", "topk_transcoder", "relu_sae", "topk_crosscoder", "relu_crosscoder")


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
    if mode == "relu_crosscoder":
        p["norms"] = np.linalg.norm(p["w_dec"], axis=1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _jax_call(mode, q, x, y, step=None):
    """The JAX entry of ``mode``; ``step`` selects the indexed form."""
    zero = jnp.zeros((), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        if mode in ("skip_transcoder", "topk_transcoder", "topk_crosscoder"):
            skip = mode == "skip_transcoder"
            yy = x if mode == "topk_crosscoder" else y
            args = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"], q.get("w_skip", zero),
                    q.get("b_skip", zero), K)
            if step is None:
                return ps.fused_transcoder_loss(x, yy, *args, BLOCK, skip,
                                                mode == "topk_crosscoder")
            return ps.fused_transcoder_loss_indexed(x, yy, jnp.int32(step), *args, BLOCK, B,
                                                    skip, mode == "topk_crosscoder")
        base = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"])
        if mode == "relu_sae":
            if step is None:
                return ps.fused_relu_sae_loss(x, *base, SW, BLOCK)
            return ps.fused_relu_sae_loss_indexed(x, jnp.int32(step), *base, SW, BLOCK, B)
        if step is None:
            return ps.fused_relu_crosscoder_loss(x, *base, q["norms"], SW, L, BLOCK)
        return ps.fused_relu_crosscoder_loss_indexed(x, jnp.int32(step), *base, q["norms"], SW,
                                                     L, BLOCK, B)


def _torch_call(mode, q, x, y, step=None):
    if mode in ("skip_transcoder", "topk_transcoder", "topk_crosscoder"):
        skip = mode == "skip_transcoder"
        args = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"], q.get("w_skip"), q.get("b_skip"),
                K)
        if step is None:
            return cc.fused_transcoder_loss(x, y, *args, skip, mode == "topk_crosscoder")
        return cc.fused_transcoder_loss_indexed(x, y, step, *args, B, skip,
                                                mode == "topk_crosscoder")
    base = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"])
    if mode == "relu_sae":
        if step is None:
            return cc.fused_relu_sae_loss(x, *base, SW)
        return cc.fused_relu_sae_loss_indexed(x, step, *base, SW, B)
    if step is None:
        return cc.fused_relu_crosscoder_loss(x, *base, q["norms"], SW, L)
    return cc.fused_relu_crosscoder_loss_indexed(x, step, *base, q["norms"], SW, L, B)


def _cotangents(mode, outs, g_resid=None, g_hid=None):
    """JAX cotangents: 1 for the loss, 0.3 / 0.7 for the ReLU families'
    recon / sparsity, the given resid / hidden cotangents, zero elsewhere."""
    cots = []
    for i, o in enumerate(outs):
        if o.dtype == jnp.bool_:
            cots.append(np.zeros(o.shape, jax.dtypes.float0))
        elif i == 0:
            cots.append(jnp.ones((), jnp.float32))
        elif mode.startswith("relu") and i in (1, 2):
            cots.append(jnp.asarray((0.3, 0.7)[i - 1], jnp.float32))
        elif i == 3 and len(outs) == 5 and not mode.startswith("relu") and g_resid is not None:
            cots.append(jnp.asarray(g_resid))
        elif i == 4 and not mode.startswith("relu") and g_hid is not None:
            cots.append(jnp.asarray(g_hid).astype(jnp.bfloat16))
        else:
            cots.append(jnp.zeros(o.shape, o.dtype))
    return tuple(cots)


def _close_grad(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-5 * float(np.max(np.abs(want))))


def _run_both(mode, p, xb, yb, step, g_resid=None, g_hid=None):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    xj, yj = jnp.asarray(xb), jnp.asarray(yb)
    outs, vjp = jax.vjp(lambda q: _jax_call(mode, q, xj, yj, step), jp)
    (jg,) = vjp(_cotangents(mode, outs, g_resid, g_hid))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    touts = _torch_call(mode, tp, torch.from_numpy(xb), torch.from_numpy(yb), step)
    roots, grads = [touts[0]], [torch.ones(())]
    if mode.startswith("relu"):
        roots += [touts[1], touts[2]]
        grads += [torch.tensor(0.3), torch.tensor(0.7)]
    elif len(touts) == 5 and g_resid is not None:
        roots += [touts[3], touts[4]]
        grads += [torch.from_numpy(g_resid), torch.from_numpy(g_hid).bfloat16()]
    torch.autograd.backward(roots, grads)
    return outs, jg, touts, tp


def _check(mode, outs, jg, touts, tp):
    np.testing.assert_allclose(float(touts[0]), float(outs[0]), rtol=1e-5)
    if mode.startswith("relu"):
        for i in (1, 2):  # recon, sparsity
            np.testing.assert_allclose(float(touts[i]), float(outs[i]), rtol=1e-5)
    l0_i = 3 if mode.startswith("relu") else 1
    assert float(touts[l0_i]) == float(outs[l0_i])
    np.testing.assert_array_equal(touts[l0_i + 1].numpy(), np.asarray(outs[l0_i + 1]))
    if len(touts) == 5 and not mode.startswith("relu"):  # resid, bf16 latent
        for got, want in ((touts[3], outs[3]), (touts[4], outs[4])):
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                                       atol=1e-2 * np.abs(want).max())
    for name in tp:
        _close_grad(tp[name].grad.numpy(), jg[name])


@pytest.mark.parametrize("mode", MODES)
def test_sliced_matches_pallas_interpret(mode):
    p = _params(mode, 1)
    x, y = _rows(2, B), _rows(3, B)
    rng = np.random.default_rng(4)
    g_resid = (rng.standard_normal((B, D)) * 1e-3).astype(np.float32)
    g_hid = np.asarray(jnp.asarray(rng.standard_normal((B, H)) * 1e-3, jnp.bfloat16)
                       .astype(jnp.float32))
    _check(mode, *_run_both(mode, p, x, y, None, g_resid, g_hid))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("step", [0, 2])
def test_indexed_matches_pallas_interpret(mode, step):
    p = _params(mode, 5)
    xbuf, ybuf = _rows(6, 3 * B), _rows(7, 3 * B)
    _check(mode, *_run_both(mode, p, xbuf, ybuf, step))


@pytest.mark.parametrize("mode", ["relu_sae", "relu_crosscoder"])
def test_hidden_sums_match_pallas_interpret(mode):
    """The per-feature hidden sums (the crosscoder's sparsity operand) and
    the L1 sum against the JAX kernel's accumulators."""
    p, x = _params(mode, 8), _rows(9, B)
    zero = jnp.zeros((), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        out = ps._fused_coder_impl(jnp.asarray(x), jnp.asarray(x), jnp.asarray(p["w_enc"]),
                                   jnp.asarray(p["b_enc"]), jnp.asarray(p["w_dec"]),
                                   jnp.asarray(p["b_dec"]), zero, zero, None, BLOCK, False, True)
    want_l1, want_hsum = float(out[5]), np.asarray(out[6])
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = cc.coder_forward_plain(torch.from_numpy(x), None,
                                 cc.operands(t["w_enc"], t["b_enc"], t["w_dec"], t["b_dec"]), None)
    np.testing.assert_allclose(float(got.l1), want_l1, rtol=1e-5)
    np.testing.assert_allclose(got.hsum.numpy(), want_hsum, rtol=0,
                               atol=1e-2 * np.abs(want_hsum).max())
    want_resid = np.asarray(out[3])
    np.testing.assert_allclose(got.resid.numpy(), want_resid, rtol=0,
                               atol=1e-2 * np.abs(want_resid).max())


@pytest.mark.parametrize("mode", MODES)
def test_indexed_window_equals_slice(mode):
    """The window at row offset 1*B is the slice, bit for bit (loss, metrics
    and every gradient)."""
    p = _params(mode, 10)
    xbuf, ybuf = torch.from_numpy(_rows(11, 2 * B + 16)), torch.from_numpy(_rows(12, 2 * B + 16))
    res = []
    for step in (1, None):
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        x, y = (xbuf, ybuf) if step == 1 else (xbuf[B:2 * B], ybuf[B:2 * B])
        outs = _torch_call(mode, tp, x, y, step)
        outs[0].backward()
        n = 5 if mode.startswith("relu") else 3
        res.append(([o.detach() for o in outs[:n]], {k: v.grad for k, v in tp.items()}))
    (oi, gi), (os_, gs) = res
    for u, v in zip(oi, os_):
        assert torch.equal(u, v)
    for k in gi:
        assert torch.equal(gi[k], gs[k]), k


def test_bf16_rows_and_targets():
    """Rows and targets staged in bf16 (a bf16 cache) widen exactly: the
    same loss as their f32 values."""
    p = {k: torch.from_numpy(v) for k, v in _params("skip_transcoder", 13).items()}
    x = torch.from_numpy(_rows(14, B)).bfloat16()
    y = torch.from_numpy(_rows(15, B)).bfloat16()
    args = (p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"], p["w_skip"], p["b_skip"], K, True)
    a = cc.fused_transcoder_loss(x, y, *args)
    b = cc.fused_transcoder_loss(x.float(), y.float(), *args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])


def test_cpu_dispatch_counts_no_launch():
    before = [e.launches for e in cc.ENTRIES]
    plain = sum(cc.plain_calls.values())
    for mode in MODES:
        p = {k: torch.from_numpy(v) for k, v in _params(mode, 16).items()}
        x, y = torch.from_numpy(_rows(17, B)), torch.from_numpy(_rows(18, B))
        _torch_call(mode, p, x, y)
        _torch_call(mode, p, x, y, 0)
    assert [e.launches for e in cc.ENTRIES] == before
    assert sum(cc.plain_calls.values()) == plain + 2 * len(MODES)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, D), device="meta")
    w = torch.empty((D, H), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cc.fused_relu_sae_loss(meta, w, torch.empty(H, device="meta"),
                               torch.empty((H, D), device="meta"), torch.empty(D, device="meta"),
                               SW)


@pytest.mark.parametrize("offset,rows", [(100, 100), (64, 200)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["relu_sae", "relu_crosscoder"])
def test_relu_route_matches_plain_and_pallas_interpret(mode, x_dtype, offset, rows):
    """The ReLU modes' CUDA route written out (``coder_route_plain``: the
    encode on whole 128-row tiles, the 64-row per-feature partials, the pad
    rows left out of every sum and count, one sum of squares a 128 x 128
    tile, the fixed-order finalize) on a ragged window at a row offset,
    with a b_enc about half of which is positive (so a pad row, whose
    pre-activation is b_enc, would count), against ``coder_forward_plain``
    and the JAX Pallas kernel in interpret mode on the same rows: the bf16
    rows and the latent bit-equal to the plain version's, l0 and active
    exact, l1, the hidden sums and sum(resid^2) at rtol 1e-6.  XLA's f32
    dot sums in another order than PyTorch's, so a latent value may round
    one bf16 step the other way against the JAX kernel (one of 25,600 here):
    there the latent is held within one step (rtol 2**-7)."""
    p = _params(mode, 20)
    assert 0.3 < float(np.mean(p["b_enc"] > 0)) < 0.7
    xbuf = torch.from_numpy(_rows(21, offset + rows + 40)).to(x_dtype)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    ops = cc.operands(t["w_enc"], t["b_enc"], t["w_dec"], t["b_dec"])
    got = cc.coder_route_plain(xbuf, offset, rows, ops, 128)
    win = xbuf[offset:offset + rows]
    plain = cc.coder_forward_plain(win, None, ops, None)

    assert torch.equal(got.xc, plain.xc) and torch.equal(got.hid, plain.hid)
    assert int(got.l0) == int(plain.l0) and torch.equal(got.active, plain.active)
    torch.testing.assert_close(got.resid, plain.resid, rtol=0, atol=0)
    for name in ("sq", "l1", "hsum"):
        torch.testing.assert_close(getattr(got, name), getattr(plain, name), rtol=1e-6, atol=0)

    zero = jnp.zeros((), jnp.float32)
    xj = jnp.asarray(win.float().numpy()).astype(jnp.bfloat16 if x_dtype == torch.bfloat16
                                                 else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        loss, l0, active, resid, hid, l1, hsum, _, _ = ps._fused_coder_impl(
            xj, xj, *(jnp.asarray(p[n]) for n in ("w_enc", "b_enc", "w_dec", "b_dec")), zero,
            zero, None, rows // 5, False, True)
    torch.testing.assert_close(got.hid.float(), torch.from_numpy(np.array(hid.astype(jnp.float32))),
                               rtol=2.0**-7, atol=0)
    assert float(np.float32(int(got.l0)) / np.float32(rows)) == float(l0)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(active))
    np.testing.assert_allclose(float(got.sq) / (rows * D), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(got.l1), float(l1), rtol=1e-6)
    np.testing.assert_allclose(got.hsum.numpy(), np.asarray(hsum), rtol=1e-6, atol=0)
