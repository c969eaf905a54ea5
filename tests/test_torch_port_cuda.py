"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip without one;
run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``
(``--noconftest``: the suite's conftest imports jax, which a card's
machine need not have).  They import no jax: the plain versions are pinned to the JAX package by
the CPU tests (test_torch_port_topk.py, test_torch_port_kernels.py).

Tolerances: the top-k mask is exact (same input, same bisection); where
the kernel computes ``pre`` itself, its tensor-core sums run in another
order than the plain f32 product, so a row whose k-th and (k+1)-th
values lie within that noise may select differently: at least 99.9% of
rows must agree, the loss at rtol 1e-4, the latent and the residual of
agreeing rows within bf16 rounding (atol 1e-2), gradients at rtol 2e-2.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_sae_tpu_torch.ops import _build, cuda_sae
from whisper_sae_tpu_torch.ops.cuda_topk import topk_mask, topk_mask_fwd
from whisper_sae_tpu_torch.ops.topk import topk_mask_plain

pytestmark = pytest.mark.cuda

D, H, K = 384, 3072, 32
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run pytest --noconftest -m cuda on the card")
    _build.load_library()
    return torch.device("cuda")


def _params(seed, d=D, h=H, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    p = {
        "w_enc": torch.randn(d, h, generator=g) * 0.05,
        "b_enc": torch.randn(h, generator=g) * 0.05,
        "b_pre": torch.randn(d, generator=g) * 0.05,
        "w_dec": torch.randn(h, d, generator=g) * 0.05,
        "b_dec": torch.randn(d, generator=g) * 0.05,
    }
    return {k: v.to(device) for k, v in p.items()}


def _rows(seed, n, d=D, device="cuda"):
    return torch.randn(n, d, generator=torch.Generator().manual_seed(seed)).to(device)


def _row_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a > 0) == (b > 0)).all(dim=1).float().mean())


@pytest.mark.parametrize("rows,h", [(64, 512), (4096, 3072), (37, 100)])
def test_topk_mask_kernel_exact(dev, rows, h):
    pre = torch.randn(rows, h, generator=torch.Generator().manual_seed(rows)).to(dev)
    pre[:4] = torch.round(pre[:4] * 2) / 2  # exact ties
    got = topk_mask_fwd(pre, min(K, h))
    torch.cuda.synchronize()
    assert torch.equal(got, topk_mask_plain(pre, min(K, h)))


def test_topk_mask_grad(dev):
    pre = torch.randn(128, H, device=dev, requires_grad=True)
    g = torch.randn(128, H, device=dev)
    topk_mask(pre, K).backward(g)
    want = torch.where(topk_mask_plain(pre.detach(), K) > 0, g, 0.0)
    assert torch.equal(pre.grad, want)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [128, 4096, 100])
def test_encode_kernel_matches_plain(dev, rows, out_dtype):
    p, x = _params(1), _rows(2, rows)
    got = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    want = cuda_sae.topk_encode_plain(x, we_t, p["b_enc"], p["b_pre"], K, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (rows, H)
    assert _row_agreement(got, want) >= 0.999
    ok = ((got > 0) == (want > 0)).all(dim=1)
    torch.testing.assert_close(got[ok].float(), want[ok].float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))


@pytest.mark.parametrize("offset,rows,n", [(0, 128, 128), (256, 128, 1024), (0, 4096, 4096),
                                          (16, 100, 200), (0, 32768, 32768)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_kernel_matches_plain(dev, offset, rows, n, x_dtype):
    p, data = _params(3), _rows(4, n).to(x_dtype)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    wd = p["w_dec"].bfloat16()
    b_out = p["b_dec"] + p["b_pre"]
    got = cuda_sae._fused_loss_launch(data, offset, rows, we_t, p["b_enc"], p["b_pre"], wd, b_out, K)
    want = cuda_sae.fused_sae_loss_plain(data[offset:offset + rows], we_t, p["b_enc"], p["b_pre"],
                                         wd, b_out, K)
    torch.cuda.synchronize()
    loss, l0, active, hid, resid, xc = got
    assert _row_agreement(hid, want[3]) >= 0.999
    torch.testing.assert_close(loss, want[0], rtol=1e-4, atol=0)
    assert torch.equal(xc, want[5])
    if _row_agreement(hid, want[3]) == 1.0:
        assert torch.equal(l0, want[1]) and torch.equal(active, want[2])
    ok = ((hid > 0) == (want[3] > 0)).all(dim=1)
    # a latent on a bf16 rounding boundary may round the other way
    torch.testing.assert_close(resid[ok], want[4][ok], rtol=0, atol=1e-2)


def _pre_gemm(xc, we_t, b_enc, out):
    """``wst_enc_gemm_fwd`` with the kPre epilogue: out = xc . we_t^T + b_enc."""
    rows, d = xc.shape
    assert _build.load_library().wst_enc_gemm_fwd(
        3, xc.data_ptr(), we_t.data_ptr(), rows, we_t.shape[0], d, b_enc.data_ptr(), 1.0, 0,
        out.data_ptr(), None, None, None, torch.cuda.current_stream().cuda_stream) == 0


def _check_pre_gemm(dev, d, h, rows):
    """The kPre GEMM against the f32 product of the same bf16 operands plus
    the bias; every element written, none past the end, two launches
    bit-identical.  Returns the operands and the output."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    g = torch.Generator().manual_seed(d + rows)
    xc = torch.randn(rows, d, generator=g).to(dev).bfloat16()
    we_t = (torch.randn(h, d, generator=g) * 0.05).to(dev).bfloat16()
    b_enc = (torch.randn(h, generator=g) * 0.05).to(dev)
    buf = torch.full((rows * h + 4096,), float("nan"), device=dev)
    pre = buf[:rows * h].view(rows, h)
    _pre_gemm(xc, we_t, b_enc, pre)
    torch.cuda.synchronize()
    want = mm_f32(xc, we_t.t()) + b_enc
    torch.testing.assert_close(pre, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    assert bool(buf[rows * h:].isnan().all())
    del want
    again = torch.empty_like(pre)
    _pre_gemm(xc, we_t, b_enc, again)
    assert torch.equal(pre, again)
    return xc, we_t, b_enc, pre


@pytest.mark.parametrize("rows", [100, 4096])
@pytest.mark.parametrize("d,h", [(384, 3072), (96, 352)])
def test_encode_pre_gemm_matches_f32_product(dev, d, h, rows):
    """Kernel A's encode, ``wst_enc_gemm_fwd`` with the kPre epilogue,
    against the f32 product of the same bf16 operands plus the bias, at
    whisper-tiny's width and at a ragged one (K a multiple of 32 but not
    of 64, N not a multiple of 128); every element is written, none past
    the end.  atol 1e-4 of the largest value: f32 sums of exact products
    in another order."""
    _check_pre_gemm(dev, d, h, rows)


@pytest.mark.parametrize("k", [1, 32])
def test_select_kernel_mask_matches_plain_on_its_pre(dev, k):
    """Kernel A's row kernel against ``topk_mask_plain`` on the pre it
    ran on (the encode GEMM again on kernel A's centred rows: it gives the
    same bits every launch): the latent bit-identical, ties included (rows
    equal to b_pre have pre = b_enc exactly, on a grid of 0.5 with 40
    entries tied at its largest value), l0 and active exact, the residual
    the decode of that latent (atol 1e-4: f32 sums of exact products in
    another order)."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    rows = 300
    p, x = _params(17), _rows(18, rows)
    p["b_enc"] = torch.round(p["b_enc"] * 40) / 2
    p["b_enc"][:40] = p["b_enc"].max()  # more than k tied at the top of those rows
    x[:8] = p["b_pre"]
    we_t = cuda_sae._bf16_t(p["w_enc"])
    wd = p["w_dec"].bfloat16()
    b_out = p["b_dec"] + p["b_pre"]
    loss, l0, active, hid, resid, xc = cuda_sae._fused_loss_launch(
        x, 0, rows, we_t, p["b_enc"], p["b_pre"], wd, b_out, k)
    pre = torch.empty(rows, H, device=dev)
    assert _build.load_library().wst_enc_gemm_fwd(
        3, xc.data_ptr(), we_t.data_ptr(), rows, H, D, p["b_enc"].data_ptr(), 1.0, 0,
        pre.data_ptr(), None, None, None, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(pre[:8], p["b_enc"].expand(8, H))
    want = topk_mask_plain(pre, k)
    assert torch.equal(hid, want.bfloat16())
    assert int((hid[:8] > 0).sum(dim=1).max()) > k  # the ties admit more than k
    # l0 is an f32 division on the card (torch divides by a scalar's reciprocal)
    assert float(l0) == float(np.float32(int((want > 0).sum()) / rows))
    assert torch.equal(active, (want > 0).any(dim=0))
    want_resid = mm_f32(hid, wd) + b_out - x
    torch.testing.assert_close(resid, want_resid, rtol=0, atol=1e-4)
    torch.testing.assert_close(loss, (want_resid * want_resid).mean(), rtol=1e-5, atol=0)


def test_fused_loss_is_four_launches(dev):
    """One call of kernel A counts one launch on its wrapper and is four
    kernels on the card, each once: the centre, the encode GEMM (kPre),
    the select-and-decode row kernel and the finalize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p, x = _params(19), _rows(20, 512)
    cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    torch.cuda.synchronize()
    before = cuda_sae.fused_sae_loss.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
        torch.cuda.synchronize()
    assert cuda_sae.fused_sae_loss.launches - before == 1
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    for name in ("sae_centre_kernel", "gemm_kernel<3>", "sae_select_decode_kernel",
                 "sae_loss_finalize_kernel"):
        assert sum(name in key for key in keys) == 1, (name, keys)


def test_fused_loss_deterministic(dev):
    p, x = _params(5), _rows(6, 4096)
    a = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    b = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _grads(fn, p):
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    fn(q).backward()
    return {k: q[k].grad for k in NAMES if q[k].grad is not None}


def test_fused_loss_grads_match_plain_on_cpu(dev):
    p, x = _params(7), _rows(8, 512)
    card = _grads(lambda q: cuda_sae.fused_sae_loss(x, *(q[n] for n in NAMES), K)[0], p)
    pc = {k: v.cpu() for k, v in p.items()}
    cpu = _grads(lambda q: cuda_sae.fused_sae_loss(x.cpu(), *(q[n] for n in NAMES), K)[0], pc)
    for name in NAMES:
        want = cpu[name]
        torch.testing.assert_close(card[name].cpu(), want, rtol=2e-2,
                                   atol=2e-2 * float(want.abs().max()))


def test_encode_grads_match_plain_on_cpu(dev):
    p, x = _params(9), _rows(10, 512)
    g = torch.randn(512, H, generator=torch.Generator().manual_seed(11))

    def run(q, xx, gg):
        return (cuda_sae.fused_topk_encode(xx, q["w_enc"], q["b_enc"], q["b_pre"], K,
                                           torch.float32) * gg).sum()

    card = _grads(lambda q: run(q, x, g.to(dev)), p)
    cpu = _grads(lambda q: run(q, x.cpu(), g), {k: v.cpu() for k, v in p.items()})
    for name in ("w_enc", "b_enc", "b_pre"):
        want = cpu[name]
        torch.testing.assert_close(card[name].cpu(), want, rtol=2e-2,
                                   atol=2e-2 * float(want.abs().max()))


def test_kernels_count_launches(dev):
    p, x = _params(12), _rows(13, 256)
    before = (cuda_sae.fused_sae_loss.launches, cuda_sae.fused_sae_loss_indexed.launches,
              cuda_sae.fused_topk_encode.launches, topk_mask_fwd.launches)
    cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    cuda_sae.fused_sae_loss_indexed(x, 1, *(p[n] for n in NAMES), K, 128)
    cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    topk_mask_fwd(torch.randn(8, H, device=dev), K)
    after = (cuda_sae.fused_sae_loss.launches, cuda_sae.fused_sae_loss_indexed.launches,
             cuda_sae.fused_topk_encode.launches, topk_mask_fwd.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]


def test_unsupported_shapes_raise(dev):
    p = _params(14, d=384, h=40992)  # wider than the blocked encode holds
    x = _rows(15, 16)
    with pytest.raises(ValueError, match="H multiples of 32 and H <= 40960"):
        cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    with pytest.raises(ValueError, match="registers"):
        topk_mask_fwd(torch.randn(4, 40992, device=dev), K)
    q = _params(16)
    with pytest.raises(ValueError, match="window"):
        cuda_sae.fused_sae_loss_indexed(x, 1, *(q[n] for n in NAMES), K, 16)
    with pytest.raises(ValueError, match="b_enc must be a contiguous torch.float32"):
        cuda_sae.fused_topk_encode(x, q["w_enc"], q["b_enc"].double(), q["b_pre"], K)
    with pytest.raises(ValueError, match="b_pre must be"):
        cuda_sae.fused_sae_loss(x, q["w_enc"], q["b_enc"], q["b_pre"][:-1], q["w_dec"],
                                q["b_dec"][:-1], K)


# ---------------------------------------------------------------------------
# whisper-large 32x geometry: the blocked encode (csrc/blocked_encode.cu)
# and kernel C's CTA-per-row form, at kernel B's and kernel C's bars
# ---------------------------------------------------------------------------

DL, HL = 1280, 40960


def test_gate_constants_match_the_library(dev):
    lib = _build.load_library()
    assert (_build.MAX_D, _build.MAX_ROW, _build.MAX_WIDE_ROW, _build.SEL_ROWS) == (
        lib.wst_max_d(), lib.wst_max_row_width(), lib.wst_max_wide_row_width(),
        lib.wst_rows_per_cta())


def test_blocked_product_gemm_matches_f32_product(dev):
    """The blocked encode's product, one chunk: the kPre GEMM at [2048 x
    1280] . [40960 x 1280]^T, where W_enc^T (105 MB) is larger than the L2
    and than A, so the GEMM walks its column tiles first, at the bar of
    test_encode_pre_gemm_matches_f32_product.  The order changes no bits:
    the same rows as the first 2048 of 41,088 (more rows than columns:
    ``gemm_kernel``, row tiles first) give the same values."""
    xc, we_t, b_enc, pre = _check_pre_gemm(dev, DL, HL, 2048)
    tall = torch.cat([xc, torch.randn(HL + 128 - 2048, DL, device=dev).bfloat16()])
    out = torch.empty(tall.shape[0], HL, device=dev)
    _pre_gemm(tall, we_t, b_enc, out)
    torch.cuda.synchronize()
    assert torch.equal(out[:2048], pre)


@pytest.mark.parametrize("h", [3104, 4096, 10000, HL])
def test_topk_mask_wide_kernel_exact(dev, h):
    pre = torch.randn(64, h, generator=torch.Generator().manual_seed(h)).to(dev)
    pre[:4] = torch.round(pre[:4] * 2) / 2  # exact ties
    before = topk_mask_fwd.wide_launches
    got = topk_mask_fwd(pre, K)
    torch.cuda.synchronize()
    assert topk_mask_fwd.wide_launches == before + 1
    assert torch.equal(got, topk_mask_plain(pre, K))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,rows", [(128, 4096, 300), (96, 4160, 129), (256, 8192, 4200),
                                      (DL, HL, 1000)])
def test_blocked_encode_matches_plain(dev, d, h, rows, x_dtype, out_dtype):
    p, x = _params(21, d=d, h=h), _rows(22, rows, d=d).to(x_dtype)
    before = (cuda_sae.fused_topk_encode.blocked_launches, cuda_sae.fused_topk_encode.launches)
    got = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
    want = cuda_sae.topk_encode_plain(x, cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K,
                                      out_dtype)
    torch.cuda.synchronize()
    assert (cuda_sae.fused_topk_encode.blocked_launches, cuda_sae.fused_topk_encode.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == out_dtype and got.shape == (rows, h)
    assert _row_agreement(got, want) >= 0.999
    ok = ((got > 0) == (want > 0)).all(dim=1)
    torch.testing.assert_close(got[ok].float(), want[ok].float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))


def test_blocked_encode_is_three_launches_a_chunk(dev):
    """A call counts one launch on its wrapper and is, for each chunk of
    ``wst_blocked_chunk_rows()`` rows, the centre (kernel A's
    ``sae_centre_kernel``), the kPre GEMM (at whisper-large 32x its
    column-tiles-first entry, ``gemm_cols_kernel``) and the CTA select on
    the card; the mma.sync product of the first
    version (``encode_gemm_kernel``) is gone.  Counted over 4 profiled
    calls of 4200 rows (3 chunks), allowing the profiler to miss one
    kernel a call (it has missed a C call's first kernel now and then)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls, rows = 4, 4200
    chunks = -(-rows // _build.load_library().wst_blocked_chunk_rows())
    p, x = _params(30, d=DL, h=HL), _rows(31, rows, d=DL)
    cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    torch.cuda.synchronize()
    before = cuda_sae.fused_topk_encode.blocked_launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
        torch.cuda.synchronize()
    assert cuda_sae.fused_topk_encode.blocked_launches - before == calls
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    for name in ("sae_centre_kernel", "gemm_cols_kernel<3>", "blocked_select_kernel"):
        seen = sum(name in key for key in keys)
        assert calls * (chunks - 1) <= seen <= calls * chunks, (name, seen, keys)
    assert not any("encode_gemm_kernel" in key or "gemm_kernel<" in key for key in keys), keys


def test_blocked_encode_deterministic(dev):
    p, x = _params(23, d=DL, h=HL), _rows(24, 2500, d=DL)
    a = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    b = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    assert torch.equal(a, b)


def test_blocked_encode_grads_match_plain_on_cpu(dev):
    """On rows whose selection the card and the CPU agree on (a row whose
    k-th and (k+1)-th pre lie within the sum-order noise may select the
    other feature, which moves whole gradient entries)."""
    p, x = _params(25, d=DL, h=HL), _rows(26, 256, d=DL)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    ok = ((cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K) > 0).cpu() == (
        cuda_sae.topk_encode_plain(x.cpu(), we_t.cpu(), p["b_enc"].cpu(), p["b_pre"].cpu(), K,
                                   torch.bfloat16) > 0)).all(dim=1)
    assert float(ok.float().mean()) >= 0.99
    x = x[ok.to(dev)].contiguous()
    g = torch.randn(x.shape[0], HL, generator=torch.Generator().manual_seed(27))

    def run(q, xx, gg):
        return (cuda_sae.fused_topk_encode(xx, q["w_enc"], q["b_enc"], q["b_pre"], K,
                                           torch.float32) * gg).sum()

    card = _grads(lambda q: run(q, x, g.to(dev)), p)
    cpu = _grads(lambda q: run(q, x.cpu(), g), {k: v.cpu() for k, v in p.items()})
    for name in ("w_enc", "b_enc", "b_pre"):
        want = cpu[name]
        torch.testing.assert_close(card[name].cpu(), want, rtol=2e-2,
                                   atol=2e-2 * float(want.abs().max()))


def test_large_loss_takes_the_blocked_route(dev):
    from whisper_sae_tpu_torch.models.sae import topk_sae_loss

    p, x = _params(28, d=DL, h=HL), _rows(29, 512, d=DL)
    before = (cuda_sae.fused_topk_encode.blocked_launches, cuda_sae.fused_sae_loss.launches)
    loss, aux = topk_sae_loss(p, x, K, torch.bfloat16)
    assert (cuda_sae.fused_topk_encode.blocked_launches, cuda_sae.fused_sae_loss.launches) == (
        before[0] + 1, before[1])
    assert bool(torch.isfinite(loss)) and float(aux["l0"]) == K


# ---------------------------------------------------------------------------
# the encoder kernels (csrc/encoder_kernels.cu) against their plain versions
# (pinned to the JAX Pallas kernels by test_torch_port_encoder_ops.py).
# Bar for one bf16 block: max|d| <= 2**-6 max|ref|, mean|d| <= 2**-9 mean|ref|;
# a whole bf16 stack per layer: 2**-4 and 2**-7.
# ---------------------------------------------------------------------------

from whisper_sae_tpu_torch.models import whisper as W  # noqa: E402
from whisper_sae_tpu_torch.ops import cuda_encoder as CE  # noqa: E402
from whisper_sae_tpu_torch.ops import encoder as E  # noqa: E402


def _close(got, want, max_rel=2.0**-6, mean_rel=2.0**-9):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    d = (g - w).abs()
    assert float(d.max()) <= max_rel * float(w.abs().max())
    assert float(d.mean()) <= mean_rel * float(w.abs().mean())


def _encoder(d, heads, f, n_mels, t, seed=0):
    arch = W.WhisperArch(d_model=d, encoder_layers=1, decoder_layers=1, num_heads=heads,
                         ffn_dim=f, n_mels=n_mels, max_source_positions=t)
    g = torch.Generator().manual_seed(seed)
    p = W.init_whisper(g, arch)
    p = W._tree_map(lambda a: a + 0.05 * torch.randn(a.shape, generator=g), p)
    enc = W.params_to(W.cast_params(p, torch.bfloat16), "cuda")["encoder"]
    return enc, W._layer(enc["layers"], 0), g


GEOMS = [(128, 2, 256, 80, 100), (384, 6, 1536, 80, 1500), (384, 6, 1536, 128, 1500),
         (768, 12, 3072, 80, 1500), (1280, 20, 5120, 128, 1500), (1536, 24, 6144, 128, 200)]


@pytest.mark.parametrize("d,heads,f,n_mels,t", GEOMS)
def test_encoder_kernels_match_plain(dev, d, heads, f, n_mels, t):
    """Every encoder kernel at whisper-tiny, -small and -large-v3 widths
    (and D=1536, the widest the fused route takes), the stem's narrow or
    wide form by width; the attention core with T unpadded and with keys masked."""
    enc, lp, g = _encoder(d, heads, f, n_mels, t)
    mel = (torch.randn(2, n_mels, 2 * t, generator=g) * 0.5).to(dev).bfloat16()
    stem = (enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"], enc["pos"])
    x = E.conv_stem_plain(mel, *stem)
    _close(CE.conv_stem_fwd(mel, *stem), x)
    rows = x.reshape(-1, d)
    q, k, v = E.ln_qkv_plain(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    for got, want in zip(CE.ln_qkv_fwd(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads),
                         (q, k, v)):
        _close(got, want)
    q, k, v = (a.view(2, t, d) for a in (q, k, v))
    for t_real in (t, t - 37):
        _close(CE.self_attention_fwd(q, k, v, heads, t_real),
               E.self_attention_plain(q, k, v, heads, t_real))
    _close(CE.flash_self_attention_fwd(q, k, v, heads), E.self_attention_plain(q, k, v, heads))
    attn = E.self_attention_plain(q, k, v, heads).reshape(-1, d)
    _close(CE.out_proj_fwd(attn, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
           E.out_proj_plain(attn, rows, lp["attn"]["wo"], lp["attn"]["bo"]))
    block = E.attention_block_plain(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    _close(CE.attention_block_fwd(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads), block)
    fl = (enc["ln_f_g"].float(), enc["ln_f_b"].float())
    brows = block.reshape(-1, d)
    for got, want in zip(CE.mlp_block_fwd(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], True, fl),
                         E.mlp_block_plain(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], True, fl)):
        _close(got, want)


# every width the MLP route takes up to the widest of the gate (F = 4D)
MLP_WIDTHS = (128, 256, 384, 512, 768, 1024, 1280, 1536)


@pytest.mark.parametrize("d", MLP_WIDTHS)
@pytest.mark.parametrize("capture,final_ln,cap_dt", [
    (False, False, torch.bfloat16), (True, False, torch.bfloat16),
    (False, True, torch.bfloat16), (True, True, torch.float32),
])
def test_mlp_kernel_all_modes(dev, capture, final_ln, cap_dt, d):
    """The MLP route (LN2, fc1 and fc2 on the Hopper GEMM, the final-LN
    capture) at every width, on a ragged 3000 - 37 rows; one launch each,
    two launches bit-identical."""
    enc, lp, g = _encoder(d, d // 64, 4 * d, 80, 1500, seed=1)
    x = torch.randn(3000 - 37, d, generator=g).to(dev).bfloat16()
    fl = (enc["ln_f_g"].float(), enc["ln_f_b"].float()) if final_ln else None
    before = CE.mlp_block_fwd.launches
    got = CE.mlp_block_fwd(x, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
    assert CE.mlp_block_fwd.launches - before == 1
    want = E.mlp_block_plain(x, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
    again = CE.mlp_block_fwd(x, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
    got, want, again = (o if isinstance(o, tuple) else (o,) for o in (got, want, again))
    assert len(got) == len(want) == 1 + final_ln + 2 * capture
    for a, b, c in zip(got, want, again):
        assert a.dtype == b.dtype
        _close(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("d", [384, 1280])
def test_encoder_gemm_mlp_epilogues(dev, d):
    """``wst_enc_gemm_fwd`` with the GELU epilogue (fc1) and with the
    residual epilogue and the pre-residual output (fc2) against a torch
    reference of each epilogue on ragged rows; fc2's output is the same
    with and without the capture, and the capture is exactly the y that
    was added; unknown epilogues and widths are refused."""
    import torch.nn.functional as F
    from whisper_sae_tpu_torch.utils.device import mm_f32

    lib, f, rows = _build.load_library(), 4 * d, 1500 - 37
    g = torch.Generator().manual_seed(d)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    a, x = r(rows, d).bfloat16(), r(rows, d).bfloat16()
    w1, w2 = r(f, d, scale=d ** -0.5).bfloat16(), r(d, f, scale=f ** -0.5).bfloat16()
    b1, b2 = r(f, scale=0.1), r(d, scale=0.1)
    h = torch.empty(rows, f, dtype=torch.bfloat16, device=dev)
    out, out2, y = (torch.empty_like(x) for _ in range(3))
    st = torch.cuda.current_stream().cuda_stream
    assert lib.wst_enc_gemm_fwd(2, a.data_ptr(), w1.data_ptr(), rows, f, d, b1.data_ptr(), 1.0, d,
                                h.data_ptr(), None, None, None, st) == 0
    _close(h, F.gelu(mm_f32(a, w1.t()) + b1).bfloat16())
    assert lib.wst_enc_gemm_fwd(1, h.data_ptr(), w2.data_ptr(), rows, d, f, b2.data_ptr(), 1.0, d,
                                out.data_ptr(), y.data_ptr(), None, x.data_ptr(), st) == 0
    assert lib.wst_enc_gemm_fwd(1, h.data_ptr(), w2.data_ptr(), rows, d, f, b2.data_ptr(), 1.0, d,
                                out2.data_ptr(), None, None, x.data_ptr(), st) == 0
    y_want = (mm_f32(h, w2.t()) + b2).bfloat16()
    _close(y, y_want)
    _close(out, (x.float() + y_want.float()).bfloat16())
    assert torch.equal(out, (x.float() + y.float()).bfloat16()) and torch.equal(out, out2)
    for epi, n in ((4, f), (2, f - 64)):
        assert lib.wst_enc_gemm_fwd(epi, a.data_ptr(), w1.data_ptr(), rows, n, d, b1.data_ptr(),
                                    1.0, d, h.data_ptr(), None, None, None, st) != 0


@pytest.mark.parametrize("d,heads,b", [(384, 6, 4), (1280, 20, 2)], ids=["tiny", "large"])
def test_attention_core_deterministic(dev, d, heads, b):
    """Two launches of the attention core give the same bits."""
    g = torch.Generator().manual_seed(d)
    q, k, v = ((torch.randn(b, 1500, d, generator=g) * s).to(dev).bfloat16()
               for s in (0.125, 1.0, 1.0))
    a = CE.self_attention_fwd(q, k, v, heads, 1437)
    assert torch.equal(a, CE.self_attention_fwd(q, k, v, heads, 1437))


# every width the fused route's gate takes (ops/encoder.py:fused_encoder_supported)
GATE_WIDTHS = (384, 512, 768, 1024, 1280, 1536)


def _attn_params(d, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to("cuda").bfloat16()

    p = {"wq": r(d, d), "wk": r(d, d), "wv": r(d, d), "wo": r(d, d), "bq": r(d), "bv": r(d),
         "bo": r(d)}
    return p, 1 + r(d), r(d)


@pytest.mark.parametrize("rows", [2 * 1500 - 37, 100])
@pytest.mark.parametrize("d", GATE_WIDTHS)
def test_encoder_gemm_matches_plain(dev, d, rows):
    """LN+QKV and the out-projection on the Hopper GEMM (csrc/encoder_gemm.cu)
    against their plain versions at every width of the gate, on a ragged
    and a small row count; two launches give the same bits."""
    heads = d // 64
    p, ln_g, ln_b = _attn_params(d, d + rows)
    x = torch.randn(rows, d, generator=torch.Generator().manual_seed(rows)).to(dev).bfloat16()
    before = (CE.ln_qkv_fwd.launches, CE.out_proj_fwd.launches)
    got = CE.ln_qkv_fwd(x, ln_g, ln_b, p, heads)
    for a, w in zip(got, E.ln_qkv_plain(x, ln_g, ln_b, p, heads)):
        _close(a, w)
    assert all(torch.equal(a, b) for a, b in zip(got, CE.ln_qkv_fwd(x, ln_g, ln_b, p, heads)))
    attn = got[2]
    out = CE.out_proj_fwd(attn, x, p["wo"], p["bo"])
    _close(out, E.out_proj_plain(attn, x, p["wo"], p["bo"]))
    assert torch.equal(out, CE.out_proj_fwd(attn, x, p["wo"], p["bo"]))
    assert (CE.ln_qkv_fwd.launches - before[0], CE.out_proj_fwd.launches - before[1]) == (2, 2)


def test_encoder_gemm_refuses_shapes(dev):
    p, ln_g, ln_b = _attn_params(320, 0)
    x = torch.zeros(64, 320, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        CE.ln_qkv_fwd(x, ln_g, ln_b, p, 5)
    with pytest.raises(ValueError, match="multiple of 128"):
        CE.out_proj_fwd(x, x, p["wo"], p["bo"])
    p, ln_g, ln_b = _attn_params(256, 0)
    x = torch.zeros(64, 384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weights"):
        CE.ln_qkv_fwd(x, ln_g, ln_b, p, 6)


def test_weights_are_prepared_once_on_the_card(dev):
    """A second attention block over the same weights builds no new
    kernel-layout weights and gives the same bits."""
    CE._prepared.clear()
    p, ln_g, ln_b = _attn_params(384, 5)
    x = torch.randn(2, 1500, 384, generator=torch.Generator().manual_seed(6)).to(dev).bfloat16()
    first = CE.attention_block_fwd(x, ln_g, ln_b, p, 6)
    entries = dict(CE._prepared)
    assert len(entries) == 2  # the q/k/v and the out-projection operands
    assert torch.equal(first, CE.attention_block_fwd(x, ln_g, ln_b, p, 6))
    assert all(CE._prepared[k][1] is v[1] for k, v in entries.items())


def test_encoder_gate_constants_match_the_library(dev):
    """The fused route's gate admits no width or head dim the kernels
    cannot take."""
    lib = _build.load_library()
    assert (E.MAX_D, E.HEAD_DIM) == (lib.wst_enc_wide_max(), lib.wst_enc_head_dim())


def test_large_v3_extraction_uses_only_kernels(dev):
    """bf16 extract_activations at whisper-large-v3 width (2+2 layers, one
    clip) launches the wide stem, the attention launches and the MLP
    route, no plain version, and agrees per layer with the card's
    composed route at the stack bar."""
    arch = W.WhisperArch(1280, 2, 2, 20, 5120, n_mels=128, vocab_size=51866)
    p = W.params_to(W.init_whisper(torch.Generator().manual_seed(6), arch), dev)
    mel = (torch.randn(1, 128, 3000, generator=torch.Generator().manual_seed(7)) * 0.5).to(dev)
    E.plain_calls.clear()
    def counts():
        return [CE.conv_stem_fwd.wide_launches, CE.ln_qkv_fwd.launches,
                CE.self_attention_fwd.launches, CE.out_proj_fwd.launches,
                CE.mlp_block_fwd.launches, CE.conv_stem_fwd.launches]

    before = counts()
    got = W.extract_activations(p, mel, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16, with_mlp=True)
    assert sum(E.plain_calls.values()) == 0
    assert [a - b for a, b in zip(counts(), before)] == [1, 2, 2, 2, 2, 0]
    want = W.extract_activations(p, mel, arch, compute_dtype=torch.bfloat16,
                                 capture_dtype=torch.bfloat16, with_mlp=True,
                                 use_fused_encoder=False)
    for key in ("encoder", "encoder_mlp_in", "encoder_mlp_out"):
        for i in range(arch.encoder_layers):
            _close(got[key][i], want[key][i], 2.0**-4, 2.0**-7)


def test_extraction_on_the_card_uses_only_kernels(dev):
    """bf16 extract_activations at whisper-tiny launches the kernels (no
    plain version) and agrees with the plain versions on the card at the
    stack bar; the f32 mode agrees with the CPU at rtol 1e-3."""
    arch = W.arch_for("openai/whisper-tiny")
    p = W.init_whisper(torch.Generator().manual_seed(2), arch)
    mel = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(3)) * 0.5
    pc = W.params_to(p, dev)
    E.plain_calls.clear()
    before = [fn.launches for fn in (CE.conv_stem_fwd, CE.ln_qkv_fwd, CE.self_attention_fwd,
                                     CE.out_proj_fwd, CE.mlp_block_fwd)]
    got = W.extract_activations(pc, mel.to(dev), arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16, with_mlp=True)
    after = [fn.launches for fn in (CE.conv_stem_fwd, CE.ln_qkv_fwd, CE.self_attention_fwd,
                                    CE.out_proj_fwd, CE.mlp_block_fwd)]
    assert sum(E.plain_calls.values()) == 0
    assert [a - b for a, b in zip(after, before)] == [1, 4, 4, 4, 4]
    want = W.extract_activations(p, mel, arch, compute_dtype=torch.bfloat16,
                                 capture_dtype=torch.bfloat16, with_mlp=True)
    for key in ("encoder", "encoder_mlp_in", "encoder_mlp_out"):
        for i in range(arch.encoder_layers):
            _close(got[key][i].cpu(), want[key][i], 2.0**-4, 2.0**-7)
    f32 = W.extract_activations(pc, mel.to(dev), arch)
    ref = W.extract_activations(p, mel, arch)
    for key in ref:
        torch.testing.assert_close(f32[key].cpu(), ref[key], rtol=1e-3, atol=1e-3)


def test_flash_route_launches_the_attention_kernel(dev):
    arch = W.arch_for("openai/whisper-tiny")
    p = W.params_to(W.cast_params(W.init_whisper(torch.Generator().manual_seed(4), arch),
                                  torch.bfloat16), dev)
    mel = (torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(5)) * 0.5)
    before = CE.flash_self_attention_fwd.launches
    with torch.no_grad():
        last, layers = W.encoder_forward(p, mel.to(dev).bfloat16(), arch, use_fused=False)
    assert CE.flash_self_attention_fwd.launches - before == arch.encoder_layers
    assert bool(torch.isfinite(layers.float()).all()) and last.shape == (2, 1500, 384)


def test_encoder_kernels_refuse_shapes(dev):
    x = torch.zeros(2, 64, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        CE.self_attention_fwd(x, x, x, 8)  # head dim 32
    with pytest.raises(ValueError, match="bfloat16"):
        CE.self_attention_fwd(x.float(), x.float(), x.float(), 4)
    enc, lp, _ = _encoder(128, 2, 256, 80, 100)
    with pytest.raises(ValueError, match="F a multiple"):
        CE.mlp_block_fwd(torch.zeros(8, 128, device=dev, dtype=torch.bfloat16), lp["ln2_g"],
                         lp["ln2_b"], {**lp["mlp"], "w1": lp["mlp"]["w1"][:, :200]})
    with pytest.raises(ValueError, match="even T_mel"):
        CE.conv_stem_fwd(torch.zeros(1, 80, 199, device=dev, dtype=torch.bfloat16),
                         enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"],
                         enc["pos"])
    mel = torch.zeros(1, 80, 200, device=dev, dtype=torch.bfloat16)
    w1 = torch.zeros(1568, 80, 3, device=dev)  # wider than the wide form
    with pytest.raises(ValueError, match="D <= 1536"):
        CE.conv_stem_fwd(mel, w1, w1[:, 0, 0], torch.zeros(1568, 1568, 3, device=dev),
                         w1[:, 0, 0], torch.zeros(100, 1568, device=dev))
    wide, _, _ = _encoder(576, 9, 2304, 80, 100)  # above 512, not a multiple of 128
    wl = W._layer(wide["layers"], 0)
    with pytest.raises(ValueError, match="multiple of 128"):
        CE.mlp_block_fwd(torch.zeros(8, 576, device=dev, dtype=torch.bfloat16),
                         wl["ln2_g"], wl["ln2_b"], wl["mlp"])


# ---------------------------------------------------------------------------
# the coder kernel (csrc/coder_kernels.cu) against its plain version (pinned
# to the JAX Pallas coder kernels by test_torch_port_coder_ops.py), in each
# of its five modes.  TopK modes take kernel A's bars above; ReLU modes: the
# latent within bf16 rounding (atol 1e-2 * max), the loss, L1 and the
# hidden sums at rtol 1e-4, the active vector equal on >= 99.9% of
# features (a pre within rounding of 0 may take the other sign).
# ---------------------------------------------------------------------------

from whisper_sae_tpu_torch.ops import cuda_coder as CC  # noqa: E402

CODER_MODES = {  # mode: (D, dout, H, k, skip, y_is_x)
    "skip_transcoder": (384, 384, 3072, 32, True, False),
    "topk_transcoder": (384, 384, 3072, 32, False, False),
    "relu_sae": (384, 384, 3072, None, False, True),
    "topk_crosscoder": (1536, 1536, 3072, 32, False, True),
    "relu_crosscoder": (1536, 1536, 3072, None, False, True),
}


def _coder_inputs(mode, n, seed, x_dtype=torch.float32, device="cuda"):
    d, dout, h, k, skip, y_is_x = CODER_MODES[mode]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).to(x_dtype)
    y = None if y_is_x else torch.randn(n, dout, generator=g).to(x_dtype)
    w_enc = torch.randn(d, h, generator=g) / d ** 0.5
    w_dec = torch.randn(h, dout, generator=g) * 0.05
    w_skip = torch.randn(d, dout, generator=g) * 0.02 if skip else None
    b_enc = torch.randn(h, generator=g) * 0.05
    b_out = torch.randn(dout, generator=g) * 0.05
    ops = CC.operands(w_enc.to(device), b_enc.to(device), w_dec.to(device), b_out.to(device),
                      None if w_skip is None else w_skip.to(device), topk=k is not None)
    return x.to(device), None if y is None else y.to(device), ops, k


def _check_coder(got, want, k, what):
    torch.cuda.synchronize()
    assert torch.equal(got.xc, want.xc), what
    torch.testing.assert_close(got.sq, want.sq, rtol=1e-4, atol=0)
    if k is not None:
        assert _row_agreement(got.hid, want.hid) >= 0.999, what
        ok = ((got.hid > 0) == (want.hid > 0)).all(dim=1)
        if bool(ok.all()):
            assert int(got.l0) == int(want.l0) and torch.equal(got.active, want.active), what
        torch.testing.assert_close(got.resid[ok], want.resid[ok], rtol=0, atol=1e-2)
        torch.testing.assert_close(got.hid[ok].float(), want.hid[ok].float(), rtol=0,
                                   atol=1e-2 * float(want.hid.float().abs().max()))
        return
    torch.testing.assert_close(got.hid.float(), want.hid.float(), rtol=0,
                               atol=1e-2 * float(want.hid.float().abs().max()))
    torch.testing.assert_close(got.resid, want.resid, rtol=0, atol=1e-2)
    torch.testing.assert_close(got.l1, want.l1, rtol=1e-4, atol=0)
    torch.testing.assert_close(got.hsum, want.hsum, rtol=1e-4,
                               atol=1e-4 * float(want.hsum.abs().max()))
    assert float((got.active == want.active).float().mean()) >= 0.999, what
    assert abs(int(got.l0) - int(want.l0)) <= 1e-4 * int(want.l0), what


@pytest.mark.parametrize("mode", list(CODER_MODES))
@pytest.mark.parametrize("offset,rows,n,x_dtype", [(0, 4096, 4096, torch.float32),
                                                   (4096, 1792, 8192, torch.float32),
                                                   (16, 100, 200, torch.bfloat16)])
def test_coder_kernel_matches_plain(dev, mode, offset, rows, n, x_dtype):
    x, y, ops, k = _coder_inputs(mode, n, 21, x_dtype)
    got = CC._coder_launch(x, y, offset, rows, ops, k)
    win = slice(offset, offset + rows)
    want = CC.coder_forward_plain(x[win], None if y is None else y[win], ops, k)
    _check_coder(got, want, k, f"{mode} [{offset}, {offset + rows})")


@pytest.mark.parametrize("mode", list(CODER_MODES))
def test_coder_kernel_deterministic(dev, mode):
    x, y, ops, k = _coder_inputs(mode, 4096, 22)
    a = CC._coder_launch(x, y, 0, 4096, ops, k)
    b = CC._coder_launch(x, y, 0, 4096, ops, k)
    for u, v in zip(a, b):
        assert u is None or torch.equal(u, v)


def _coder_loss(mode, q, x, y):
    if mode.startswith("relu"):
        norms = torch.linalg.vector_norm(q["w_dec"], dim=1) if mode == "relu_crosscoder" else None
        if norms is None:
            return CC.fused_relu_sae_loss(x, q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"], 0.01)[0]
        return CC.fused_relu_crosscoder_loss(x, q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"],
                                             norms, 0.01, 4)[0]
    return CC.fused_transcoder_loss(x, y, q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"],
                                    q.get("w_skip"), q.get("b_skip"), 32, "w_skip" in q,
                                    mode == "topk_crosscoder")[0]


@pytest.mark.parametrize("mode", list(CODER_MODES))
def test_coder_grads_match_plain_on_cpu(dev, mode):
    d, dout, h, k, skip, y_is_x = CODER_MODES[mode]
    g = torch.Generator().manual_seed(23)
    p = {"w_enc": torch.randn(d, h, generator=g) / d ** 0.5,
         "b_enc": torch.randn(h, generator=g) * 0.05,
         "w_dec": torch.randn(h, dout, generator=g) * 0.05,
         "b_dec": torch.randn(dout, generator=g) * 0.05}
    if skip:
        p.update(w_skip=torch.randn(d, dout, generator=g) * 0.02,
                 b_skip=torch.randn(dout, generator=g) * 0.05)
    x = torch.randn(512, d, generator=g)
    y = None if y_is_x else torch.randn(512, dout, generator=g)
    card = _grads_all(lambda q: _coder_loss(mode, q, x.to(dev), None if y is None else y.to(dev)),
                      {k_: v.to(dev) for k_, v in p.items()})
    cpu = _grads_all(lambda q: _coder_loss(mode, q, x, y), p)
    for name, want in cpu.items():
        got = card[name].cpu()
        close = torch.isclose(got, want, rtol=2e-2, atol=2e-2 * float(want.abs().max()))
        if k is None:
            # a pre within rounding of 0 takes the other sign on one side and
            # moves that feature's whole gradient column: a few elements
            assert float(close.float().mean()) >= 0.9999, name
        else:
            assert bool(close.all()), name


def _grads_all(fn, p):
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    fn(q).backward()
    return {k: v.grad for k, v in q.items()}


def test_coder_kernel_counts_launches(dev):
    x, y, ops, k = _coder_inputs("skip_transcoder", 256, 24)
    w = {"w_enc": torch.randn(384, 3072, device=dev) * 0.05,
         "b_enc": torch.zeros(3072, device=dev), "w_dec": torch.randn(3072, 384, device=dev),
         "b_dec": torch.zeros(384, device=dev)}
    before = [e.launches for e in CC.ENTRIES]
    plain = sum(CC.plain_calls.values())
    CC.fused_transcoder_loss(x, y, *w.values(), None, None, 32, False)
    CC.fused_transcoder_loss_indexed(x, y, 1, *w.values(), None, None, 32, 128, False)
    CC.fused_relu_sae_loss(x, *w.values(), 0.01)
    CC.fused_relu_sae_loss_indexed(x, 1, *w.values(), 0.01, 128)
    norms = torch.ones(3072, device=dev)
    CC.fused_relu_crosscoder_loss(x, *w.values(), norms, 0.01, 1)
    CC.fused_relu_crosscoder_loss_indexed(x, 1, *w.values(), norms, 0.01, 1, 128)
    assert [e.launches - b for e, b in zip(CC.ENTRIES, before)] == [1] * 6
    assert sum(CC.plain_calls.values()) == plain


def test_coder_kernel_refuses_shapes(dev):
    x, y, ops, k = _coder_inputs("topk_transcoder", 64, 25)
    with pytest.raises(ValueError, match="multiples of 32"):
        CC._coder_launch(x[:, :100].contiguous(), y, 0, 64,
                         CC.operands(torch.zeros(100, 3072, device=dev), ops.b_enc,
                                     torch.zeros(3072, 384, device=dev), ops.b_out, topk=True), k)
    with pytest.raises(ValueError, match="window"):
        CC._coder_launch(x, y, 32, 64, ops, k)
    with pytest.raises(ValueError, match="b_enc must be"):
        CC._coder_launch(x, y, 0, 64, ops._replace(b_enc=ops.b_enc.double()), k)


# ---------------------------------------------------------------------------
# the coder kernel's ReLU modes: five launches, the encode and the decode on
# the Hopper GEMM (csrc/encoder_gemm.cu: gemm_kernel<kRelu>, gemm_kernel<kResid>),
# at the phase-8 bars of chip_smoke.py (those of _check_coder above)
# ---------------------------------------------------------------------------

RELU_PARTS = ("coder_cast_kernel", "gemm_kernel<4>", "gemm_kernel<5>", "coder_hsum_kernel",
              "coder_sum_kernel")


@pytest.mark.parametrize("mode", ["relu_sae", "relu_crosscoder"])
@pytest.mark.parametrize("offset,rows,n,x_dtype", [
    (0, 128, 128, torch.float32), (0, 128, 128, torch.bfloat16),
    (37, 100, 300, torch.float32), (37, 100, 300, torch.bfloat16),
    (300, 1000, 1400, torch.float32), (300, 1000, 1400, torch.bfloat16)])
def test_coder_relu_route_matches_plain(dev, mode, offset, rows, n, x_dtype):
    """Sliced and at a row offset, on windows whose last 128-row tile is
    ragged (100, 1000: its pad rows have pre = b_enc, about half positive,
    and must count nowhere), f32 and bf16 rows."""
    x, _, ops, _ = _coder_inputs(mode, n, 26, x_dtype)
    assert 0.3 < float((ops.b_enc > 0).float().mean()) < 0.7
    got = CC._coder_launch(x, None, offset, rows, ops, None)
    want = CC.coder_forward_plain(x[offset:offset + rows], None, ops, None)
    _check_coder(got, want, None, f"{mode} [{offset}, {offset + rows})")


@pytest.mark.parametrize("rows", [100, 4096])
@pytest.mark.parametrize("d,h", [(384, 3072), (1536, 3072), (96, 352)])
def test_coder_gemms_match_f32_product(dev, d, h, rows):
    """``wst_coder_gemm_fwd`` alone: the kRelu encode against bf16(relu(the
    f32 product of the same bf16 operands + b_enc)) (one bf16 step, rtol
    2**-7; atol 1e-4 of the largest value for a pre within f32 rounding of
    0), its 64-row column sums (rtol 1e-4; positive exactly where a row
    below m is, on >= 99.9% of them) and l0 (rel 1e-4) against the same
    of the plain f32 values over the rows below m; the kResid decode
    of that latent against its f32 product + b_dec - x (atol 1e-4 of the
    largest value: f32 sums in another order) and its tile sums of squares
    (rtol 1e-4).  Nothing is written past the outputs' ends; at (96, 352)
    K is a multiple of 32, not 64, and N not of 128."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    lib = _build.load_library()
    st = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(d + h + rows)
    off = 5
    x = torch.randn(off + rows, d, generator=g).to(dev)
    xc = x[off:].bfloat16()
    we_t = (torch.randn(h, d, generator=g) / d ** 0.5).to(dev).bfloat16()
    b_enc = (torch.randn(h, generator=g) * 0.05).to(dev)
    wd_t = (torch.randn(d, h, generator=g) * 0.05).to(dev).bfloat16()
    b_dec = (torch.randn(d, generator=g) * 0.05).to(dev)
    tile = lib.wst_gemm_tile()
    halves, tiles = -(-rows // (tile // 2)), -(-rows // tile) * -(-d // tile)

    def guarded(numel, dtype):  # the output, then a tail that must stay NaN
        buf = torch.full((numel + 4096,), float("nan"), device=dev, dtype=dtype)
        return buf, buf[:numel]

    hbuf, hid = guarded(rows * h, torch.bfloat16)
    pbuf, part = guarded(halves * h, torch.float32)
    l0 = torch.zeros(1, dtype=torch.int32, device=dev)
    assert lib.wst_coder_gemm_fwd(4, xc.data_ptr(), we_t.data_ptr(), rows, h, d, b_enc.data_ptr(),
                                  hid.data_ptr(), part.data_ptr(), l0.data_ptr(), None, 0, 0,
                                  st) == 0
    torch.cuda.synchronize()
    hidden = torch.relu(mm_f32(xc, we_t.t()) + b_enc)
    hmax = float(hidden.abs().max())
    torch.testing.assert_close(hid.view(rows, h).float(), hidden.bfloat16().float(), rtol=2.0**-7,
                               atol=1e-4 * hmax)
    pad = torch.zeros(halves * (tile // 2) - rows, h, device=dev)
    want_part = torch.cat([hidden, pad]).view(halves, tile // 2, h).sum(dim=1)
    torch.testing.assert_close(part.view(halves, h), want_part, rtol=1e-4,
                               atol=1e-4 * float(want_part.abs().max()))
    pos = hidden > 0
    assert abs(int(l0) - int(pos.sum())) <= 1e-4 * int(pos.sum())
    want_any = torch.cat([pos, pad.bool()]).view(halves, tile // 2, h).any(dim=1)
    assert float(((part.view(halves, h) > 0) == want_any).float().mean()) >= 0.999
    assert bool(hbuf[rows * h:].isnan().all()) and bool(pbuf[halves * h:].isnan().all())

    rbuf, resid = guarded(rows * d, torch.float32)
    sbuf, sq = guarded(tiles, torch.float32)
    assert lib.wst_coder_gemm_fwd(5, hid.data_ptr(), wd_t.data_ptr(), rows, d, h, b_dec.data_ptr(),
                                  resid.data_ptr(), sq.data_ptr(), None, x.data_ptr(), 0, off,
                                  st) == 0
    torch.cuda.synchronize()
    want = mm_f32(hid.view(rows, h), wd_t.t()) + b_dec - x[off:]
    torch.testing.assert_close(resid.view(rows, d), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    mt, nt = -(-rows // tile), -(-d // tile)
    wpad = torch.cat([want, torch.zeros(mt * tile - rows, d, device=dev)])
    wpad = torch.cat([wpad, torch.zeros(mt * tile, nt * tile - d, device=dev)], dim=1)
    want_sq = (wpad * wpad).view(mt, tile, nt, tile).sum(dim=(1, 3)).flatten()
    torch.testing.assert_close(sq, want_sq, rtol=1e-4, atol=0)
    assert bool(rbuf[rows * d:].isnan().all()) and bool(sbuf[tiles:].isnan().all())


def test_coder_relu_is_five_launches(dev):
    """A ReLU call counts one launch on its wrapper and is five kernels on
    the card, none more than once a call; the TopK modes' encode and select
    do not run.  Over 4 profiled calls each kernel is seen at least once and
    at most 4 times: the profiler has missed the first kernel of a C call
    now and then (coder_cast_kernel here; kernel A's sae_centre_kernel, 2
    of 10, in another run), which ran, as every result test shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = 4
    x, _, ops, _ = _coder_inputs("relu_sae", 512, 27)
    w = (ops.we_t.t().float(), ops.b_enc, ops.wd_t.t().float(), ops.b_out)
    CC.fused_relu_sae_loss(x, *w, 0.01)
    torch.cuda.synchronize()
    before = CC.fused_relu_sae_loss.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            CC.fused_relu_sae_loss(x, *w, 0.01)
        torch.cuda.synchronize()
    assert CC.fused_relu_sae_loss.launches - before == calls
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    for name in RELU_PARTS:
        assert 1 <= sum(name in key for key in keys) <= calls, (name, keys)
    assert not any("coder_select_decode_kernel" in key or "gemm_kernel<3>" in key
                   for key in keys), keys


@pytest.mark.parametrize("mode", ["relu_sae", "relu_crosscoder"])
@pytest.mark.parametrize("offset,rows", [(37, 100), (300, 1000)])
def test_coder_relu_route_deterministic(dev, mode, offset, rows):
    x, _, ops, _ = _coder_inputs(mode, offset + rows + 50, 28)
    a = CC._coder_launch(x, None, offset, rows, ops, None)
    b = CC._coder_launch(x, None, offset, rows, ops, None)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_coder_relu_route_refuses(dev):
    x, _, ops, _ = _coder_inputs("relu_sae", 64, 29)
    with pytest.raises(ValueError, match="own target"):
        CC._coder_launch(x, x.clone(), 0, 64, ops, None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        CC._coder_launch(x.view(-1)[2:2 + 63 * 384].view(63, 384), None, 0, 63, ops, None)


# ---------------------------------------------------------------------------
# the coder kernel's TopK modes on kernel A's route: the cast, the kPre encode
# on the Hopper GEMM (twice in Skip mode: the skip product is the second),
# coder_select_decode_kernel and coder_sum_kernel, at the bars of
# _check_coder above
# ---------------------------------------------------------------------------

TOPK_MODES = ("skip_transcoder", "topk_transcoder", "topk_crosscoder")


@pytest.mark.parametrize("mode", TOPK_MODES)
@pytest.mark.parametrize("offset,rows,n,x_dtype", [
    (0, 4096, 4096, torch.float32), (4096, 4096, 8192, torch.bfloat16),
    (37, 100, 300, torch.float32), (37, 100, 300, torch.bfloat16)])
def test_coder_topk_route_matches_both_plain_versions(dev, mode, offset, rows, n, x_dtype):
    """Sliced, at a row offset and on a 100-row window (not a whole number
    of the select's 4-row CTAs), f32 and bf16 rows, against
    ``coder_forward_plain`` and the route written out
    (``coder_topk_route_plain``, 384-column passes)."""
    x, y, ops, k = _coder_inputs(mode, n, 30, x_dtype)
    got = CC._coder_launch(x, y, offset, rows, ops, k)
    win = slice(offset, offset + rows)
    want = CC.coder_forward_plain(x[win], None if y is None else y[win], ops, k)
    _check_coder(got, want, k, f"{mode} [{offset}, {offset + rows})")
    route = CC.coder_topk_route_plain(x, y, offset, rows, ops, k, 384)
    _check_coder(got, route, k, f"{mode} [{offset}, {offset + rows}) route")


def test_coder_topk_crosscoder_at_32768_rows(dev):
    """The TopK crosscoder (dout = 1536: four decode passes) at 32768 rows
    against both plain versions."""
    x, y, ops, k = _coder_inputs("topk_crosscoder", 32768, 31)
    got = CC._coder_launch(x, y, 0, 32768, ops, k)
    _check_coder(got, CC.coder_forward_plain(x, None, ops, k), k, "topk_crosscoder 32768")
    _check_coder(got, CC.coder_topk_route_plain(x, None, 0, 32768, ops, k, 384), k,
                 "topk_crosscoder 32768 route")


@pytest.mark.parametrize("mode", TOPK_MODES)
def test_coder_select_matches_plain_on_its_pre(dev, mode):
    """The select and decode against the plain version on the pre they
    ran on (the kPre GEMM again on the call's bf16 rows: it gives the same
    bits every launch): the latent bit-identical, l0 and active exact, the
    residual the decode of that latent plus the base, minus y (atol 1e-4 of
    the largest value: f32 sums of exact products in another order)."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    offset, rows = 37, 300
    x, y, ops, k = _coder_inputs(mode, offset + rows + 20, 32)
    got = CC._coder_launch(x, y, offset, rows, ops, k)
    h = ops.we_t.shape[0]
    pre = torch.empty(rows, h, device=dev)
    _pre_gemm(got.xc, ops.we_t, ops.b_enc, pre)
    torch.cuda.synchronize()
    want = topk_mask_plain(pre, k)
    assert torch.equal(got.hid, want.bfloat16())
    assert int(got.l0) == int((want > 0).sum()) and torch.equal(got.active, (want > 0).any(dim=0))
    win = slice(offset, offset + rows)
    base = ops.b_out if ops.ws_t is None else mm_f32(got.xc, ops.ws_t.t()) + ops.b_out
    target = x[win] if y is None else y[win]
    want_resid = mm_f32(got.hid, ops.wd) + base - target
    torch.testing.assert_close(got.resid, want_resid, rtol=0,
                               atol=1e-4 * float(want_resid.abs().max()))
    torch.testing.assert_close(got.sq, (want_resid * want_resid).sum(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", TOPK_MODES)
@pytest.mark.parametrize("offset,rows", [(37, 100), (300, 1000)])
def test_coder_topk_route_deterministic(dev, mode, offset, rows):
    x, y, ops, k = _coder_inputs(mode, offset + rows + 50, 33)
    a = CC._coder_launch(x, y, offset, rows, ops, k)
    b = CC._coder_launch(x, y, offset, rows, ops, k)
    for u, v in zip(a, b):
        assert u is None or torch.equal(u, v)


@pytest.mark.parametrize("mode", TOPK_MODES)
def test_coder_topk_is_four_or_five_launches(dev, mode):
    """A TopK call counts one launch on its wrapper and is four kernels on
    the card (five in Skip mode, whose skip product is a second
    gemm_kernel<3>); the ReLU modes' GEMMs do not run.  Counted over 4
    profiled calls, as in test_coder_relu_is_five_launches: each kernel at
    least once a call but for the first of a C call, which the profiler
    has missed now and then."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = 4
    x, y, ops, k = _coder_inputs(mode, 512, 34)
    skip = mode == "skip_transcoder"
    w = (ops.we_t.t().float(), ops.b_enc, ops.wd.float(), ops.b_out)
    extra = (ops.ws_t.t().float(), torch.zeros_like(ops.b_out)) if skip else (None, None)

    def call():
        return CC.fused_transcoder_loss(x, y, *w, *extra, k, skip, y is None)

    call()
    torch.cuda.synchronize()
    before = CC.fused_transcoder_loss.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    assert CC.fused_transcoder_loss.launches - before == calls
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    parts = {"coder_cast_kernel": 1, "gemm_kernel<3>": 2 if skip else 1,
             "coder_select_decode_kernel": 1, "coder_sum_kernel": 1}
    for name, per_call in parts.items():
        assert 1 <= sum(name in key for key in keys) <= per_call * calls, (name, keys)
    assert sum("gemm_kernel<3>" in key for key in keys) >= (calls + 1 if skip else 1), keys
    assert not any(name in key for key in keys for name in ("gemm_kernel<4>", "gemm_kernel<5>",
                                                            "coder_hsum_kernel")), keys


def test_coder_topk_route_refuses(dev):
    """x and W_skip^T must be 16-byte aligned (the cast reads x 16 bytes at
    a time, TMA reads W_skip^T); TopK mode needs W_dec as its rows."""
    x, y, ops, k = _coder_inputs("skip_transcoder", 64, 35)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        CC._coder_launch(x.view(-1)[2:2 + 63 * 384].view(63, 384), y[:63].contiguous(), 0, 63,
                         ops, k)
    ws = torch.empty(384 * 384 + 8, dtype=torch.bfloat16, device=dev)[2:2 + 384 * 384]
    with pytest.raises(ValueError, match="w_skip_t must be 16-byte aligned"):
        CC._coder_launch(x, y, 0, 64, ops._replace(ws_t=ws.view(384, 384)), k)
    relu_ops = ops._replace(wd=None, wd_t=ops.wd.t().contiguous())
    with pytest.raises(ValueError, match="TopK mode reads W_dec"):
        CC._coder_launch(x, y, 0, 64, relu_ops, k)
