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


def _encode_args(p):
    return cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [128, 4096, 4100])
def test_encode_latent_equals_kernel_a(dev, rows, x_dtype):
    """Kernel B's bf16 latent is kernel A's on the same rows, bit for bit:
    both select on the kPre GEMM's pre of the same centred rows with the
    same warp select (4100: a ragged last tile)."""
    p, x = _params(40), _rows(41, rows).to(x_dtype)
    we_t, b_enc, b_pre, k = _encode_args(p)
    got = cuda_sae._topk_encode_launch(x, we_t, b_enc, b_pre, k, torch.bfloat16)
    hid = cuda_sae._fused_loss_launch(x, 0, rows, we_t, b_enc, b_pre, p["w_dec"].bfloat16(),
                                      p["b_dec"] + b_pre, k)[3]
    torch.cuda.synchronize()
    assert torch.equal(got, hid)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_encode_equals_blocked_encode_at_tiny(dev, out_dtype):
    """Kernel B at D=384, H=3072 (the warp select, one chunk) against the
    select of the blocked encode at whisper-large 32x (the CTA form) on
    the pre kernel B left in its workspace: both selects stop at the first
    midpoint that counts exactly k, so the latents have the same bits."""
    lib = _build.load_library()
    rows = 4100
    p, x = _params(42), _rows(43, rows)
    we_t, b_enc, b_pre, k = _encode_args(p)
    out_f32 = int(out_dtype == torch.float32)
    got = torch.empty((rows, H), dtype=out_dtype, device=dev)
    ws = torch.empty((lib.wst_sae_topk_encode_workspace_bytes(rows, D, H),), dtype=torch.uint8,
                     device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.wst_sae_topk_encode_fwd(
        x.data_ptr(), 0, rows, D, H, k, we_t.data_ptr(), b_enc.data_ptr(), b_pre.data_ptr(),
        got.data_ptr(), out_f32, ws.data_ptr(), stream) == 0
    want = torch.empty_like(got)
    cta = _build.SELECT_FORMS.index("cta")
    assert lib.wst_encode_select_fwd(cta, ws.data_ptr(), rows, H, k, want.data_ptr(), out_f32, 0,
                                     stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, cuda_sae._topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_encode_writes_every_element(dev, out_dtype):
    """The C call on an output and a workspace filled with NaN, each with a
    guard tail: every element of the latent, of the chunk's f32 pre and of
    its centred rows is written, nothing past either end; the latent is the
    wrapper's, and the workspace holds the kPre pre and the centre's rows."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    lib = _build.load_library()
    rows = 300
    p, x = _params(44), _rows(45, rows)
    we_t, b_enc, b_pre, k = _encode_args(p)
    out = torch.full((rows * H + 4096,), float("nan"), dtype=out_dtype, device=dev)
    nbytes = lib.wst_sae_topk_encode_workspace_bytes(rows, D, H)
    assert nbytes == rows * H * 4 + rows * D * 2
    ws = torch.full((nbytes + 4096,), 255, dtype=torch.uint8, device=dev)  # NaN in f32 and bf16
    assert lib.wst_sae_topk_encode_fwd(
        x.data_ptr(), 0, rows, D, H, k, we_t.data_ptr(), b_enc.data_ptr(), b_pre.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.float32), ws.data_ptr(),
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    hidden = out[:rows * H].view(rows, H)
    assert not bool(hidden.isnan().any()) and bool(out[rows * H:].isnan().all())
    assert torch.equal(hidden, cuda_sae._topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype))
    pre = ws[:rows * H * 4].view(torch.float32).view(rows, H)
    xc = ws[rows * H * 4:nbytes].view(torch.bfloat16).view(rows, D)
    assert bool((ws[nbytes:] == 255).all())
    assert torch.equal(xc, (x - b_pre).bfloat16())
    want = mm_f32(xc, we_t.t()) + b_enc
    torch.testing.assert_close(pre, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_encode_deterministic(dev, out_dtype):
    p, x = _params(46), _rows(47, 4096)
    args = (*_encode_args(p), out_dtype)
    assert torch.equal(cuda_sae._topk_encode_launch(x, *args), cuda_sae._topk_encode_launch(x, *args))


def test_encode_runs_two_chunks_at_32768_rows(dev):
    """32,768 rows are two chunks (27,264 + 5,504 at H = 3072): each of the
    three launches -- the centre, the kPre GEMM (row tiles first:
    ``gemm_kernel<3>``), the warp select (``topk_mask_kernel``) -- twice a
    call, counted over 3 profiled calls: the GEMM and the select exactly
    twice a call, the centre at least once (the profiler has missed a C
    call's first kernel now and then, which is the first chunk's centre
    here; the second chunk's is seen); one count on the wrapper a call.  The latent agrees with the
    plain version at the bars of test_encode_kernel_matches_plain and with
    kernel A's (one chunk) bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows, calls = 32768, 3
    chunks = -(-rows // _build.load_library().wst_sae_topk_encode_chunk_rows(H))
    assert chunks == 2
    p, x = _params(48), _rows(49, rows)
    we_t, b_enc, b_pre, k = _encode_args(p)
    got = cuda_sae.fused_topk_encode(x, p["w_enc"], b_enc, b_pre, k)
    torch.cuda.synchronize()
    before = cuda_sae.fused_topk_encode.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cuda_sae.fused_topk_encode(x, p["w_enc"], b_enc, b_pre, k)
        torch.cuda.synchronize()
    assert cuda_sae.fused_topk_encode.launches - before == calls
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    for name, least in (("sae_centre_kernel", calls * (chunks - 1)),
                        ("gemm_kernel<3>", calls * chunks), ("topk_mask_kernel", calls * chunks)):
        seen = sum(name in key for key in keys)
        assert least <= seen <= calls * chunks, (name, seen, keys)
    assert not any("gemm_cols_kernel" in key or "blocked_select" in key for key in keys), keys
    want = cuda_sae.topk_encode_plain(x, we_t, b_enc, b_pre, k, torch.bfloat16)
    assert _row_agreement(got, want) >= 0.999
    ok = ((got > 0) == (want > 0)).all(dim=1)
    torch.testing.assert_close(got[ok].float(), want[ok].float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))
    hid = cuda_sae._fused_loss_launch(x, 0, rows, we_t, b_enc, b_pre, p["w_dec"].bfloat16(),
                                      p["b_dec"] + b_pre, k)[3]
    assert torch.equal(got, hid)


def test_encode_misaligned_w_enc_t_raises(dev):
    """W_enc^T is read by TMA: an address off 16 bytes is refused."""
    p, x = _params(50), _rows(51, 64)
    we_t, b_enc, b_pre, k = _encode_args(p)
    flat = torch.empty(H * D + 8, dtype=torch.bfloat16, device=dev)
    off = flat[1:1 + H * D].view(H, D)
    off.copy_(we_t)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_sae._topk_encode_launch(x, off, b_enc, b_pre, k, torch.bfloat16)


def test_topk_encode_chunk_rows_match_the_library(dev):
    lib = _build.load_library()
    for h in (32, 384, 3072, 4096, 40960, 49152, 81920, 262144, 655360, 655392, 1 << 20):
        assert lib.wst_sae_topk_encode_chunk_rows(h) == _build.topk_encode_chunk_rows(h), h
        assert lib.wst_select_form(h) == _build.SELECT_FORMS.index(_build.select_form(h)), h
        if _build.select_form(h) == "cluster":
            assert lib.wst_cluster_ctas(h) == _build.cluster_ctas(h), h


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
    p = _params(14, d=32, h=(1 << 20) + 32)  # wider than the blocked encode holds
    x = _rows(15, 16, d=32)
    with pytest.raises(ValueError, match="H multiples of 32 and H <= 1048576"):
        cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    with pytest.raises(ValueError, match="H <= 262144"):
        topk_mask_fwd(torch.randn(4, 262176, device=dev), K)
    x = _rows(15, 16)
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
    assert (_build.MAX_D, _build.MAX_ROW, _build.MAX_WIDE_ROW, _build.SEL_ROWS,
            _build.MAX_GROUP_ROW, _build.MAX_BLOCKED_ROW,
            _build.MAX_MASK_ROW) == (
        lib.wst_max_d(), lib.wst_max_row_width(), lib.wst_max_wide_row_width(),
        lib.wst_rows_per_cta(), lib.wst_max_group_row_width(), lib.wst_max_blocked_row_width(),
        lib.wst_max_mask_row_width())


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
def test_blocked_encode_matches_plain(dev, d, h, rows, x_dtype, out_dtype, monkeypatch):
    """The blocked encode through ``fused_topk_encode``: at whisper-large
    32x by its own gate, at the narrower widths (kernel B's within the JAX
    package's budget) with the gate patched on, as past the budget."""
    monkeypatch.setattr(cuda_sae, "uses_blocked", lambda *a: True)
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
    ``wst_sae_topk_encode_chunk_rows(H)`` rows, the centre (kernel A's
    ``sae_centre_kernel``), the kPre GEMM (at whisper-large 32x its
    column-tiles-first entry, ``gemm_cols_kernel``) and the CTA select on
    the card; the mma.sync product of the first
    version (``encode_gemm_kernel``) is gone.  Counted over 4 profiled
    calls of 4200 rows (3 chunks), allowing the profiler to miss one
    kernel a call (it has missed a C call's first kernel now and then)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls, rows = 4, 4200
    chunks = -(-rows // _build.load_library().wst_sae_topk_encode_chunk_rows(HL))
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
# the top-k encode and mask at every width the JAX package takes: kernel B
# within 48 MiB of bf16 W_enc (the group, CTA and cluster selects), the
# blocked encode and kernel C past H = 40960 (the cluster form)
# ---------------------------------------------------------------------------

# (D, H): whisper-small 8x, whisper-large 8x, whisper-tiny 128x, the widest row at D = 384
ENCODE_FORMS = [(768, 6144, "group"), (1280, 10240, "cta"), (384, 49152, "cluster"),
                (384, 65536, "cluster")]


def _check_encode(got, want, rows, h, out_dtype):
    assert got.dtype == out_dtype and got.shape == (rows, h)
    assert _row_agreement(got, want) >= 0.999
    ok = ((got > 0) == (want > 0)).all(dim=1)
    torch.testing.assert_close(got[ok].float(), want[ok].float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,h,form", ENCODE_FORMS)
def test_encode_forms_match_plain(dev, d, h, form, out_dtype):
    """Kernel B through ``fused_topk_encode`` at each select form past the
    warp select: one kernel-B launch, one select a chunk in the form
    ``_build.select_form`` names and none in another, the latent at kernel
    B's bars, two launches bit-identical."""
    rows = 4096
    assert _build.select_form(h) == form and not cuda_sae.uses_blocked(d, h)
    p, x = _params(60 + d, d=d, h=h), _rows(61, rows, d=d)
    enc = cuda_sae.fused_topk_encode
    before = (enc.launches, enc.blocked_launches, cuda_sae.encode_select_launches())
    got = enc(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
    forms = cuda_sae.encode_select_launches()
    chunks = -(-rows // _build.topk_encode_chunk_rows(h))
    assert (enc.launches, enc.blocked_launches) == (before[0] + 1, before[1])
    assert {f: n - before[2][f] for f, n in forms.items()} == {
        f: chunks if f == form else 0 for f in _build.SELECT_FORMS}
    args = (cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K, out_dtype)
    _check_encode(got, cuda_sae.topk_encode_plain(x, *args), rows, h, out_dtype)
    assert torch.equal(got, cuda_sae._topk_encode_launch(x, *args))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_blocked_encode_spill_form_matches_plain(dev, out_dtype):
    """The blocked encode at whisper-large 64x (D = 1280, H = 81920): chunks
    of 1024 rows (the budget's), the cluster select each chunk."""
    d, h, rows = 1280, 81920, 2100
    assert cuda_sae.uses_blocked(d, h) and _build.topk_encode_chunk_rows(h) == 1024
    p, x = _params(62, d=d, h=h), _rows(63, rows, d=d)
    enc = cuda_sae.fused_topk_encode
    before = (enc.blocked_launches, cuda_sae.encode_select_launches()["cluster"])
    got = enc(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
    assert (enc.blocked_launches, cuda_sae.encode_select_launches()["cluster"]) == (
        before[0] + 1, before[1] + 3)
    want = cuda_sae.topk_encode_plain(x, cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K,
                                      out_dtype)
    _check_encode(got, want, rows, h, out_dtype)


@pytest.mark.parametrize("rows,h", [(4096, 49152), (1024, 81920), (64, 262144), (32, 98336),
                                    (16, 50001)])
def test_topk_mask_spill_form_exact(dev, rows, h):
    """Kernel C past H = 40960 (the cluster form: 2 CTAs a row up to 81920,
    4 at 98,336, 8 at 262,144; 50,001 no multiple of 4, so its loads and
    stores one value at a time): exact, counted in ``.wide_launches`` and
    ``.cluster_launches``."""
    pre = torch.randn(rows, h, generator=torch.Generator().manual_seed(h)).to(dev)
    pre[:4] = torch.round(pre[:4] * 2) / 2  # exact ties
    before = (topk_mask_fwd.launches, topk_mask_fwd.wide_launches, topk_mask_fwd.cluster_launches)
    got = topk_mask_fwd(pre, K)
    torch.cuda.synchronize()
    assert (topk_mask_fwd.launches, topk_mask_fwd.wide_launches, topk_mask_fwd.cluster_launches) == (
        before[0], before[1] + 1, before[2] + 1)
    assert torch.equal(got, topk_mask_plain(pre, K))


@pytest.mark.parametrize("h,rows", [(655392, 1100), (1 << 20, 1100)])
def test_blocked_encode_widest_rows_match_plain(dev, h, rows):
    """The encode at its widest rows, D = 64 (bf16 W_enc past 48 MiB: the
    blocked encode): chunks of fewer rows than a GEMM tile (127 at
    655,392, 80 at 2^20, each with a ragged last chunk), the cluster select
    of 8 CTAs a row reading the rest of each slice past 40960 values again
    each pass, at kernel B's bars."""
    d = 64
    chunk = _build.topk_encode_chunk_rows(h)
    assert chunk < 128 and rows % chunk and cuda_sae.uses_blocked(d, h)
    p, x = _params(66, d=d, h=h), _rows(67, rows, d=d)
    enc = cuda_sae.fused_topk_encode
    before = (enc.blocked_launches, cuda_sae.encode_select_launches()["cluster"])
    got = enc(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    assert (enc.blocked_launches, cuda_sae.encode_select_launches()["cluster"]) == (
        before[0] + 1, before[1] + -(-rows // chunk))
    want = cuda_sae.topk_encode_plain(x, cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K,
                                      torch.bfloat16)
    _check_encode(got, want, rows, h, torch.bfloat16)


def test_encode_and_mask_limits_refuse(dev):
    h = _build.MAX_BLOCKED_ROW + 32
    p, x = _params(64, d=32, h=h), _rows(65, 8, d=32)
    with pytest.raises(ValueError, match="H <= 1048576"):
        cuda_sae._topk_encode_launch(x, cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K,
                                     torch.bfloat16)
    with pytest.raises(ValueError, match="H <= 262144"):
        topk_mask_fwd(torch.zeros(2, 262176, device=dev), K)
    lib = _build.load_library()
    pre = torch.zeros(2, 40992, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    # each form refuses a width it does not hold
    for form, width in (("group", 8224), ("group", 4100), ("cta", 40992), ("cluster", 40960),
                        ("cluster", _build.MAX_BLOCKED_ROW + 32), ("warp", 1024)):
        assert lib.wst_encode_select_fwd(_build.SELECT_FORMS.index(form), pre.data_ptr(), 1,
                                         width, K, pre.data_ptr(), 1, 0, stream) != 0, form


def _cluster_select(pre, k, out_dtype=torch.float32, rows=None):
    """The cluster select alone (``wst_encode_select_fwd``, uncounted) on the
    first ``rows`` rows of an f32 pre."""
    lib = _build.load_library()
    rows = pre.shape[0] if rows is None else rows
    out = torch.zeros((rows, pre.shape[1]), dtype=out_dtype, device=pre.device)
    err = lib.wst_encode_select_fwd(_build.SELECT_FORMS.index("cluster"), pre.data_ptr(), rows,
                                    pre.shape[1], k, out.data_ptr(),
                                    int(out_dtype == torch.float32), 0,
                                    torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


def _cluster_edge_rows(h, dev):
    """More than the compaction's 8192 candidates tied at the k-th value,
    all equal, all negative, +0.0 and -0.0 straddling the k-th, 15,000
    tied at the k-th of a gaussian row."""
    g = torch.Generator().manual_seed(h + 3)
    pre = torch.randn(5, h, generator=g)
    pre[0, :10000] = pre[0].max()
    pre[1] = 1.5
    pre[2] = -pre[2].abs() - 1
    pre[3] = torch.where(torch.rand(h, generator=g) < 0.5, 0.0, -0.0)
    pre[3, :20] = 1.0
    pre[4, 5000:20000] = 2.0
    return pre.to(dev)


# (rows, H): one row; more rows than the card's CTAs (132 x the cluster's)
CLUSTER_SHAPES = [(1, 49152), (300, 49152), (1, 81920), (300, 81920), (2, 163840), (600, 163840),
                  (1, 262144), (1100, 262144)]


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("rows,h", CLUSTER_SHAPES)
def test_cluster_select_exact(dev, rows, h, k):
    """The cluster select (2, 4 and 8 CTAs a row) against the plain mask:
    bit for bit in f32, and in bf16 the plain latent rounded."""
    assert _build.select_form(h) == "cluster" and (rows * _build.cluster_ctas(h) > 132 or rows < 3)
    pre = torch.randn(rows, h, generator=torch.Generator().manual_seed(rows + h + k)).to(dev)
    pre[: min(rows, 2)] *= 3.0
    want = topk_mask_plain(pre, k)
    got = _cluster_select(pre, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(_cluster_select(pre, k, torch.bfloat16), want.bfloat16())


@pytest.mark.parametrize("h", [49152, 81920, 262144, 655392])
def test_cluster_select_edge_rows_exact(dev, h):
    """Ties past the compaction's cap, all-equal, all-negative and signed-zero
    rows, at k = 32 and k = H; two launches bit-identical."""
    pre = _cluster_edge_rows(h, dev)
    for k in (32, h):
        got = _cluster_select(pre, k)
        torch.cuda.synchronize()
        assert torch.equal(got, topk_mask_plain(pre, k)), k
        assert torch.equal(got, _cluster_select(pre, k)), k


def test_cluster_select_unaligned_rows_exact(dev):
    """Rows whose start is not 16-byte aligned (a pre at an offset of one
    value, and a width no multiple of 4): the loads, copies and stores one
    value at a time."""
    h, rows = 49152, 64
    flat = torch.randn(rows * h + 1, generator=torch.Generator().manual_seed(9)).to(dev)
    pre = flat[1:].view(rows, h)
    assert pre.data_ptr() % 16
    assert torch.equal(_cluster_select(pre, K), topk_mask_plain(pre, K))
    odd = torch.randn(70, 81922, generator=torch.Generator().manual_seed(10)).to(dev)
    assert torch.equal(_cluster_select(odd, K), topk_mask_plain(odd, K))


def test_cluster_select_counted_by_form(dev):
    """The encode counts its selects past H = 40960 as the cluster form, and
    kernel C in ``.cluster_launches``; the C entry alone counts nothing."""
    pre = torch.randn(16, 49152, generator=torch.Generator().manual_seed(11)).to(dev)
    forms = cuda_sae.encode_select_launches()
    before = topk_mask_fwd.cluster_launches
    _cluster_select(pre, K)
    topk_mask_fwd(pre, K)
    assert topk_mask_fwd.cluster_launches == before + 1
    assert cuda_sae.encode_select_launches() == forms
    p, x = _params(68, d=384, h=49152), _rows(69, 100, d=384)
    cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    now = cuda_sae.encode_select_launches()
    assert {f: now[f] - forms[f] for f in now} == {f: int(f == "cluster") for f in now}


def test_cluster_select_fits_the_card(dev):
    """Every cluster size the select takes has clusters resident at once."""
    lib = _build.load_library()
    for h in (49152, 81920, 163840, 262144, _build.MAX_BLOCKED_ROW):
        assert lib.wst_cluster_ctas(h) == _build.cluster_ctas(h)
        assert lib.wst_cluster_select_max_active(h) > 0, h


# ---------------------------------------------------------------------------
# kernel A's wide route (sae_fused_loss_wide_fwd: one CTA a row, the
# decode's warps over D) at the geometries the JAX package fuses past the
# warp form, at kernel A's bars
# ---------------------------------------------------------------------------

WIDE_GEOMS = [(512, 4096), (768, 6144), (1024, 8192), (384, 24576), (768, 3072)]
# the wide route's select-and-decode by form (_build.wide_form), by the profiler's kernel names
WIDE_SELECT = {"group": "sae_select_decode_group_kernel", "cta": "sae_select_decode_wide_kernel"}


def _wide_args(p):
    return cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], p["w_dec"].bfloat16(), \
        p["b_dec"] + p["b_pre"]


@pytest.mark.parametrize("offset,rows,n", [(0, 4096, 4096), (256, 128, 1024), (16, 100, 200)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", WIDE_GEOMS)
def test_wide_fused_loss_matches_plain(dev, d, h, offset, rows, n, x_dtype):
    p, data = _params(d + h, d, h), _rows(d + h + 1, n, d).to(x_dtype)
    we_t, b_enc, b_pre, wd, b_out = _wide_args(p)
    got = cuda_sae._fused_loss_launch(data, offset, rows, we_t, b_enc, b_pre, wd, b_out, K, True)
    want = cuda_sae.fused_sae_loss_plain(data[offset:offset + rows], we_t, b_enc, b_pre, wd, b_out, K)
    torch.cuda.synchronize()
    loss, l0, active, hid, resid, xc = got
    assert _row_agreement(hid, want[3]) >= 0.999
    torch.testing.assert_close(loss, want[0], rtol=1e-4, atol=0)
    assert torch.equal(xc, want[5])
    ok = ((hid > 0) == (want[3] > 0)).all(dim=1)
    if bool(ok.all()):
        assert torch.equal(l0, want[1]) and torch.equal(active, want[2])
    torch.testing.assert_close(hid[ok].float(), want[3][ok].float(), rtol=0,
                               atol=1e-2 * float(want[3].float().abs().max()))
    torch.testing.assert_close(resid[ok], want[4][ok], rtol=0, atol=1e-2)


@pytest.mark.parametrize("offset", [0, 4096])
def test_wide_route_equals_warp_form_at_tiny(dev, offset):
    """At D=384, H=3072 both forms hold the geometry: the same list order
    and the same fmaf chain give the same latent, residual and centred rows."""
    p, data = _params(30), _rows(31, 8192)
    args = _wide_args(p)
    wide = cuda_sae._fused_loss_launch(data, offset, 4096, *args, K, True)
    warp = cuda_sae._fused_loss_launch(data, offset, 4096, *args, K, False)
    torch.cuda.synchronize()
    for i in (1, 2, 3, 4, 5):
        assert torch.equal(wide[i], warp[i]), i
    torch.testing.assert_close(wide[0], warp[0], rtol=1e-5, atol=0)


def test_wide_route_deterministic_over_chunks(dev):
    p, x = _params(32, 768, 6144), _rows(33, 32768, 768)
    a = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    b = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_wide_route_launches_a_chunk(dev):
    """One call at 32768 rows of whisper-small 8x counts one wide launch
    and is the centre, three chunks (13,568 rows) of the encode GEMM and
    the wide select-and-decode (its group form at H = 6144), and the
    finalize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p, x = _params(34, 768, 6144), _rows(35, 32768, 768)
    cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    torch.cuda.synchronize()
    before = (cuda_sae.fused_sae_loss.launches, cuda_sae.fused_sae_loss.wide_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
        torch.cuda.synchronize()
    assert (cuda_sae.fused_sae_loss.launches, cuda_sae.fused_sae_loss.wide_launches) == (
        before[0] + 1, before[1] + 1)
    chunks = -(-32768 // _build.topk_encode_chunk_rows(6144))
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    for name, n in (("sae_centre_kernel", 1), ("gemm_kernel<3>", chunks),
                    (WIDE_SELECT[_build.wide_form(6144)], chunks), ("sae_loss_finalize_kernel", 1)):
        assert sum(name in key for key in keys) == n, (name, keys)


def test_wide_grads_match_plain_on_cpu(dev):
    p, x = _params(36, 768, 6144), _rows(37, 512, 768)
    card = _grads(lambda q: cuda_sae.fused_sae_loss(x, *(q[n] for n in NAMES), K)[0], p)
    pc = {k: v.cpu() for k, v in p.items()}
    cpu = _grads(lambda q: cuda_sae.fused_sae_loss(x.cpu(), *(q[n] for n in NAMES), K)[0], pc)
    for name in NAMES:
        want = cpu[name]
        torch.testing.assert_close(card[name].cpu(), want, rtol=2e-2,
                                   atol=2e-2 * float(want.abs().max()))


def test_small_loss_takes_the_wide_route(dev):
    """At whisper-small 8x the loss is kernel A's wide route and the top-k
    encode (eval, resampling) takes kernel B, its group-form select."""
    from whisper_sae_tpu_torch.models.sae import topk_sae_loss

    p, x = _params(38, 768, 6144), _rows(39, 512, 768)
    enc = cuda_sae.fused_topk_encode
    before = (cuda_sae.fused_sae_loss.wide_launches, enc.launches, enc.blocked_launches)
    loss, aux = topk_sae_loss(p, x, K, torch.bfloat16)
    forms = cuda_sae.encode_select_launches()
    enc(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    assert (cuda_sae.fused_sae_loss.wide_launches, enc.launches, enc.blocked_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert cuda_sae.encode_select_launches()["group"] == forms["group"] + 1
    assert bool(torch.isfinite(loss)) and float(aux["l0"]) == K


def test_wide_route_refuses(dev):
    p, x = _params(40, 384, 40992), _rows(41, 16)
    args = _wide_args(p)
    with pytest.raises(ValueError, match="H <= 40960"):
        cuda_sae._fused_loss_launch(x, 0, 16, *args, K, True)
    with pytest.raises(ValueError, match="window"):
        q = _wide_args(_params(42, 768, 6144))
        cuda_sae._fused_loss_launch(_rows(43, 16, 768), 8, 16, *q, K, True)


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
    (and D=1536, the widest the fused route takes), the stem's three
    launches at every width; the attention core with T unpadded and with
    keys masked."""
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


def _stem_case(dev, d: int, n_mels: int, b: int, t: int) -> None:
    """conv_stem_fwd against conv_stem_plain on ``b`` random clips of ``t``
    output frames, its scratch taken from an allocator cache poisoned with
    NaN (the pad rows are written on every call); one launch a call, two
    calls bit-identical."""
    g = torch.Generator().manual_seed(d + n_mels + t)

    def r(*shape, scale):
        return (torch.randn(*shape, generator=g) * scale).to(dev).bfloat16()

    stem = (r(d, n_mels, 3, scale=(3 * n_mels) ** -0.5), r(d, scale=0.1),
            r(d, d, 3, scale=(3 * d) ** -0.5), r(d, scale=0.1), r(t, d, scale=0.1))
    mel = r(b, n_mels, 2 * t, scale=0.5)
    want = E.conv_stem_plain(mel, *stem)
    for shape in ((b, 2 * t + 2, n_mels), (b, 2 * t + 1, d)):  # the wrapper's two scratch tensors
        torch.full(shape, float("nan"), device=dev, dtype=torch.bfloat16)
    before = CE.conv_stem_fwd.launches
    got = CE.conv_stem_fwd(mel, *stem)
    assert CE.conv_stem_fwd.launches - before == 1
    _close(got, want)
    assert torch.equal(got, CE.conv_stem_fwd(mel, *stem))


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("d", range(128, 1537, 128))
def test_conv_stem_every_width(dev, d, n_mels):
    """The stem (the prep, then conv1 and conv2 as tap products on the
    Hopper GEMM) at every width the fused route takes, for 80 and 128 mels,
    on two clips of 100 output frames: conv1's 200 rows and conv2's 100 end
    inside a tile, and a clip boundary is crossed."""
    _stem_case(dev, d, n_mels, 2, 100)


@pytest.mark.parametrize("n_mels,d", [(80, 384), (128, 1280)])
def test_conv_stem_three_full_clips(dev, n_mels, d):
    """Three 30-second clips (T = 1500: 24 conv1 tiles and 12 conv2 tiles
    a clip, the last of each partial) at whisper-tiny and -large-v3 widths."""
    _stem_case(dev, d, n_mels, 3, 1500)


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
    clip) launches the stem, the attention launches and the MLP route, no
    plain version, and agrees per layer with the card's composed route at
    the stack bar."""
    arch = W.WhisperArch(1280, 2, 2, 20, 5120, n_mels=128, vocab_size=51866)
    p = W.params_to(W.init_whisper(torch.Generator().manual_seed(6), arch), dev)
    mel = (torch.randn(1, 128, 3000, generator=torch.Generator().manual_seed(7)) * 0.5).to(dev)
    E.plain_calls.clear()
    def counts():
        return [CE.conv_stem_fwd.launches, CE.ln_qkv_fwd.launches,
                CE.self_attention_fwd.launches, CE.out_proj_fwd.launches,
                CE.mlp_block_fwd.launches]

    before = counts()
    got = W.extract_activations(p, mel, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16, with_mlp=True)
    assert sum(E.plain_calls.values()) == 0
    assert [a - b for a, b in zip(counts(), before)] == [1, 2, 2, 2, 2]
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
    w1 = torch.zeros(1664, 80, 3, device=dev)  # wider than the fused route's gate
    with pytest.raises(ValueError, match="D <= 1536"):
        CE.conv_stem_fwd(mel, w1, w1[:, 0, 0], torch.zeros(1664, 1664, 3, device=dev),
                         w1[:, 0, 0], torch.zeros(100, 1664, device=dev))
    w1 = torch.zeros(96, 80, 3, device=dev)  # the GEMM's tiles need D a multiple of 128
    with pytest.raises(ValueError, match="multiple of 128"):
        CE.conv_stem_fwd(mel, w1, w1[:, 0, 0], torch.zeros(96, 96, 3, device=dev),
                         w1[:, 0, 0], torch.zeros(100, 96, device=dev))
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


def _coder_inputs(mode, n, seed, x_dtype=torch.float32, device="cuda", modes=CODER_MODES):
    d, dout, h, k, skip, y_is_x = modes[mode]
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


# ---------------------------------------------------------------------------
# the coder kernel past H = 3072 (every geometry the JAX package fuses): the
# TopK modes' wide route (wst_coder_wide_fwd: the cast, the skip product, per
# chunk the kPre encode and coder_select_decode_wide_kernel, the sum), the
# ReLU modes' one route, at the bars of _check_coder above
# ---------------------------------------------------------------------------

WIDE_CODER_MODES = {  # whisper-small 8x; the crosscoders as 2 layers of 384 (S = 6144)
    mode: (768, 768, 6144, k, skip, y_is_x)
    for mode, (_, _, _, k, skip, y_is_x) in CODER_MODES.items()
}


@pytest.mark.parametrize("mode", TOPK_MODES)
@pytest.mark.parametrize("offset,rows,n,x_dtype", [
    (0, 4096, 4096, torch.float32), (4096, 4096, 8192, torch.bfloat16),
    (37, 100, 300, torch.float32)])
def test_coder_wide_route_matches_both_plain_versions(dev, mode, offset, rows, n, x_dtype):
    """Sliced, at a row offset and on a ragged window, against
    ``coder_forward_plain`` and the wide route written out
    (``coder_topk_route_plain``: 32-column tiles, one partial a row)."""
    x, y, ops, k = _coder_inputs(mode, n, 40, x_dtype, modes=WIDE_CODER_MODES)
    got = CC._coder_launch(x, y, offset, rows, ops, k, True)
    win = slice(offset, offset + rows)
    want = CC.coder_forward_plain(x[win], None if y is None else y[win], ops, k)
    _check_coder(got, want, k, f"{mode} wide [{offset}, {offset + rows})")
    route = CC.coder_topk_route_plain(x, y, offset, rows, ops, k, 32, per_row=True)
    _check_coder(got, route, k, f"{mode} wide [{offset}, {offset + rows}) route")


@pytest.mark.parametrize("mode", TOPK_MODES)
def test_coder_wide_route_equals_warp_form(dev, mode):
    """At H = 3072 (the crosscoder at L*D = 1536) the wide route's latent,
    residual, bf16 rows, l0 and active equal the warp form's bit for bit:
    the same selections listed in feature order, each column the same fmaf
    chain."""
    x, y, ops, k = _coder_inputs(mode, 1200, 41)
    wide = CC._coder_launch(x, y, 37, 1000, ops, k, True)
    warp = CC._coder_launch(x, y, 37, 1000, ops, k, False)
    torch.cuda.synchronize()
    for name in ("hid", "resid", "xc", "l0", "active"):
        assert torch.equal(getattr(wide, name), getattr(warp, name)), name
    torch.testing.assert_close(wide.sq, warp.sq, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["relu_sae", "relu_crosscoder"])
@pytest.mark.parametrize("offset,rows,n", [(0, 4096, 4096), (37, 100, 300)])
def test_coder_relu_route_at_6144(dev, mode, offset, rows, n):
    """The ReLU modes' one route at H = 6144 (the hidden sums' partials
    [ceil(rows / 64), H], coder_hsum_kernel over them)."""
    x, y, ops, k = _coder_inputs(mode, n, 42, modes=WIDE_CODER_MODES)
    got = CC._coder_launch(x, y, offset, rows, ops, k)
    win = slice(offset, offset + rows)
    _check_coder(got, CC.coder_forward_plain(x[win], None, ops, k), k, f"{mode} H=6144")


@pytest.mark.parametrize("h", [24576, 32768])
def test_coder_relu_route_up_to_32768(dev, h):
    """The ReLU SAE at D = 384 up to H = 32768, the widest the 48 MiB
    budget admits there: the GEMMs' 64-bit indexing, the [ceil(rows / 64),
    H] hidden-sum partials and coder_hsum_kernel over them."""
    modes = {"relu_sae": (384, 384, h, None, False, True)}
    assert CC.coder_supported(384, 384, h)
    x, _, ops, k = _coder_inputs("relu_sae", 4096, 47, modes=modes)
    got = CC._coder_launch(x, None, 0, 4096, ops, k)
    _check_coder(got, CC.coder_forward_plain(x, None, ops, k), k, f"relu_sae H={h}")


def test_coder_wide_route_deterministic_over_chunks(dev):
    """16,384 rows at H = 6144 run two chunks (13,568 + 2,816): two calls
    give the same bits, the loss included."""
    rows = 16384
    assert _build.topk_encode_chunk_rows(6144) < rows
    x, y, ops, k = _coder_inputs("skip_transcoder", rows, 43, modes=WIDE_CODER_MODES)
    a = CC._coder_launch(x, y, 0, rows, ops, k, True)
    b = CC._coder_launch(x, y, 0, rows, ops, k, True)
    for u, v in zip(a, b):
        assert u is None or torch.equal(u, v)
    _check_coder(a, CC.coder_forward_plain(x, y, ops, k), k, "skip_transcoder two chunks")


def test_coder_counts_wide_launches(dev):
    """Each entry counts every launch in ``.launches`` and those past H =
    3072 also in ``.wide_launches``, in every mode; no plain version runs."""
    entries = CC.ENTRIES
    plain = sum(CC.plain_calls.values())
    for h, wide in ((3072, 0), (6144, 1)):
        g = torch.Generator(device=dev).manual_seed(h)
        w = {"w_enc": torch.randn(384, h, generator=g, device=dev) / 384 ** 0.5,
             "b_enc": torch.zeros(h, device=dev),
             "w_dec": torch.randn(h, 384, generator=g, device=dev) * 0.05,
             "b_dec": torch.zeros(384, device=dev)}
        x = torch.randn(256, 384, generator=g, device=dev)
        before = [(e.launches, e.wide_launches) for e in entries]
        CC.fused_transcoder_loss(x, x, *w.values(), None, None, 32, False)
        CC.fused_transcoder_loss_indexed(x, x, 1, *w.values(), None, None, 32, 128, False)
        CC.fused_relu_sae_loss(x, *w.values(), 0.01)
        CC.fused_relu_sae_loss_indexed(x, 1, *w.values(), 0.01, 128)
        norms = torch.ones(h, device=dev)
        CC.fused_relu_crosscoder_loss(x, *w.values(), norms, 0.01, 1)
        CC.fused_relu_crosscoder_loss_indexed(x, 1, *w.values(), norms, 0.01, 1, 128)
        assert [(e.launches - b[0], e.wide_launches - b[1])
                for e, b in zip(entries, before)] == [(1, wide)] * 6, h
    assert sum(CC.plain_calls.values()) == plain


def test_coder_wide_entry_limits(dev):
    """The wide C entry takes H up to wst_max_wide_row_width() and refuses
    past it, and k < 1; the wrapper refuses the wide route in ReLU mode and
    the warp form past wst_max_row_width()."""
    lib = _build.load_library()
    assert lib.wst_max_wide_row_width() == _build.MAX_WIDE_ROW
    t = torch.zeros(64, device=dev)
    ptr = t.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    for h, k in ((lib.wst_max_wide_row_width() + 32, 32), (6144, 0)):
        err = lib.wst_coder_wide_fwd(ptr, 0, ptr, 0, 0, 4, 32, h, 32, k, 0, 0, ptr, ptr, ptr, ptr,
                                     None, ptr, ptr, ptr, ptr, ptr, ptr, ptr, stream)
        assert err != 0, (h, k)
    x, y, ops, k = _coder_inputs("topk_transcoder", 64, 44, modes=WIDE_CODER_MODES)
    with pytest.raises(ValueError, match="warp select"):
        CC._coder_launch(x, y, 0, 64, ops, k, False)
    xr, _, relu_ops, _ = _coder_inputs("relu_sae", 64, 45, modes=WIDE_CODER_MODES)
    with pytest.raises(ValueError, match="the ReLU modes take every H"):
        CC._coder_launch(xr, None, 0, 64, relu_ops, None, True)
    wide = 40992
    over = CC.operands(torch.zeros(32, wide, device=dev), torch.zeros(wide, device=dev),
                       torch.zeros(wide, 32, device=dev), torch.zeros(32, device=dev), topk=True)
    with pytest.raises(ValueError, match="one CTA's registers"):
        CC._coder_launch(torch.zeros(8, 32, device=dev), torch.zeros(8, 32, device=dev), 0, 8,
                         over, 32, True)


def test_small_transcoder_takes_the_wide_route(dev):
    """``transcoder_loss`` at whisper-small 8x under AMP: one launch of the
    coder kernel on its wide route, and the loss its plain version's."""
    from whisper_sae_tpu_torch.models import transcoder as TC

    x, y, ops, k = _coder_inputs("skip_transcoder", 512, 46, modes=WIDE_CODER_MODES)
    p = {"w_enc": ops.we_t.t().float(), "b_enc": ops.b_enc, "w_dec": ops.wd.float(),
         "b_dec": ops.b_out, "w_skip": ops.ws_t.t().float(), "b_skip": torch.zeros_like(ops.b_out)}
    e = CC.fused_transcoder_loss
    before = (e.launches, e.wide_launches)
    loss, aux = TC.transcoder_loss(p, x, y, 32, torch.bfloat16)
    assert (e.launches, e.wide_launches) == (before[0] + 1, before[1] + 1)
    want = CC.coder_forward_plain(x, y, ops, k)
    torch.testing.assert_close(loss, want.sq / (512 * 768), rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# the wide routes' group form (csrc/select_decode.cuh: group_select_decode,
# kernel A's sae_select_decode_group_kernel and the coder's
# coder_select_decode_group_kernel) at each instantiated width, in kernel A
# and the three TopK modes, and the dispatch between it and the
# CTA-per-row form; at the bars above
# ---------------------------------------------------------------------------

# N = 32, 48 and 64 values a thread, and a row ending inside a thread's run column
GROUP_WIDTHS = [(512, 4096), (768, 6144), (1024, 8192), (384, 4160)]
# rows not a multiple of a CTA's rows, and fewer rows than SMs
GROUP_ROWS = [(0, 4096, 4096), (3, 1001, 1200), (5, 7, 20)]
GROUP_MODES = ["kernel_a", *TOPK_MODES]


def _group_coder_modes(mode, d, h):
    _, _, _, k, skip, y_is_x = CODER_MODES[mode]
    return {mode: (d, d, h, k, skip, y_is_x)}


def _check_wide_a(got, want, what):
    torch.cuda.synchronize()
    loss, l0, active, hid, resid, xc = got
    assert _row_agreement(hid, want[3]) >= 0.999, what
    torch.testing.assert_close(loss, want[0], rtol=1e-4, atol=0)
    assert torch.equal(xc, want[5]), what
    ok = ((hid > 0) == (want[3] > 0)).all(dim=1)
    if bool(ok.all()):
        # the same count: the kernel divides it by the rows, torch multiplies
        # by their reciprocal (one f32 rounding apart past a power of 2)
        rows = hid.shape[0]
        assert round(float(l0) * rows) == round(float(want[1]) * rows), what
        assert torch.equal(active, want[2]), what
    torch.testing.assert_close(hid[ok].float(), want[3][ok].float(), rtol=0,
                               atol=1e-2 * float(want[3].float().abs().max()))
    torch.testing.assert_close(resid[ok], want[4][ok], rtol=0, atol=1e-2)


def _group_call(mode, d, h, offset, rows, n, seed):
    """(card output, plain version's) of ``mode`` on its wide route over
    rows [offset, offset + rows) of ``n``."""
    if mode == "kernel_a":
        p, data = _params(seed, d, h), _rows(seed + 1, n, d)
        args = _wide_args(p)
        return (cuda_sae._fused_loss_launch(data, offset, rows, *args, K, True),
                cuda_sae.fused_sae_loss_plain(data[offset:offset + rows], *args, K))
    x, y, ops, k = _coder_inputs(mode, n, seed, modes=_group_coder_modes(mode, d, h))
    win = slice(offset, offset + rows)
    return (CC._coder_launch(x, y, offset, rows, ops, k, True),
            CC.coder_forward_plain(x[win], None if y is None else y[win], ops, k))


@pytest.mark.parametrize("offset,rows,n", GROUP_ROWS)
@pytest.mark.parametrize("mode", GROUP_MODES)
@pytest.mark.parametrize("d,h", GROUP_WIDTHS)
def test_group_form_matches_plain(dev, d, h, mode, offset, rows, n):
    """Every width the group form is instantiated for, in each mode, sliced
    and at a row offset, on whole and ragged CTAs, against the plain
    version (and the coder's against its route written out)."""
    assert _build.wide_form(h) == "group"
    got, want = _group_call(mode, d, h, offset, rows, n, d + h + rows)
    what = f"{mode} D={d} H={h} [{offset}, {offset + rows})"
    if mode == "kernel_a":
        _check_wide_a(got, want, what)
        return
    _check_coder(got, want, K, what)
    x, y, ops, k = _coder_inputs(mode, n, d + h + rows, modes=_group_coder_modes(mode, d, h))
    _check_coder(got, CC.coder_topk_route_plain(x, y, offset, rows, ops, k, 32, per_row=True), k,
                 what + " route")


@pytest.mark.parametrize("k,ties", [(1, "top40"), (32, "top40"), (32, "all"), (2000, "top40")])
@pytest.mark.parametrize("mode", GROUP_MODES)
def test_group_form_ties_match_plain_on_its_pre(dev, mode, k, ties):
    """Rows whose pre is b_enc exactly (kernel A: x = b_pre; the coder: x =
    0), b_enc on a grid of 0.5 with 40 entries tied at its largest value
    (``all``: every entry equal and positive, so all 6144 are selected),
    at whisper-small 8x: the latent bit-identical to ``topk_mask_plain`` on
    the pre the kPre GEMM gives the kernel's bf16 rows (more than k
    selected on the tie rows), l0 and active exact, the residual the
    decode of that latent (atol 1e-4 of its largest value: f32 sums in
    another order).  The ``all`` rows and k = 2000 list thousands of
    selections a row."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    d, h, rows = 768, 6144, 300
    p = _params(50, d, h)
    b_enc = torch.round(p["b_enc"] * 40) / 2
    b_enc[:40] = b_enc.max()
    if ties == "all":
        b_enc[:] = 0.5
    x = _rows(51, rows, d)
    if mode == "kernel_a":
        x[:8] = p["b_pre"]
        we_t, _, b_pre, wd, b_out = _wide_args(p)
        loss, l0, active, hid, resid, xc = cuda_sae._fused_loss_launch(x, 0, rows, we_t, b_enc,
                                                                       b_pre, wd, b_out, k, True)
        base, target = b_out, x
    else:
        _, _, _, _, skip, y_is_x = CODER_MODES[mode]
        x[:8] = 0.0
        y = None if y_is_x else _rows(52, rows, d)
        w_skip = torch.randn(d, d, generator=torch.Generator().manual_seed(53)).to(dev) * 0.02
        ops = CC.operands(p["w_enc"], b_enc, p["w_dec"], p["b_dec"], w_skip if skip else None,
                          topk=True)
        out = CC._coder_launch(x, y, 0, rows, ops, k, True)
        l0, active, hid, resid, xc = out.l0, out.active, out.hid, out.resid, out.xc
        we_t, wd = ops.we_t, ops.wd
        base = ops.b_out + (mm_f32(xc, ops.ws_t.t()) if skip else 0.0)
        target = x if y is None else y
    pre = torch.empty(rows, h, device=dev)
    _pre_gemm(xc, we_t, b_enc, pre)
    torch.cuda.synchronize()
    assert torch.equal(pre[:8], b_enc.expand(8, h))
    want = topk_mask_plain(pre, k)
    assert torch.equal(hid, want.bfloat16())
    assert int((hid[:8] > 0).sum(dim=1).max()) > k  # the ties admit more than k
    assert int(l0 if mode != "kernel_a" else round(float(l0) * rows)) == int((want > 0).sum())
    assert torch.equal(active, (want > 0).any(dim=0))
    want_resid = mm_f32(hid, wd) + base - target
    torch.testing.assert_close(resid, want_resid, rtol=0,
                               atol=1e-4 * max(1.0, float(want_resid.abs().max())))


@pytest.mark.parametrize("mode", ["kernel_a", "skip_transcoder"])
def test_group_form_across_chunks_windowed(dev, mode):
    """More rows than one chunk at H = 6144 (13,568 + 1,233), read at a row
    offset into a longer buffer: against the plain version, and two calls
    bit-identical."""
    rows = _build.topk_encode_chunk_rows(6144) + 1233
    got, want = _group_call(mode, 768, 6144, 77, rows, rows + 200, 54)
    if mode == "kernel_a":
        _check_wide_a(got, want, "kernel_a two chunks")
    else:
        _check_coder(got, want, K, f"{mode} two chunks")
    again, _ = _group_call(mode, 768, 6144, 77, rows, rows + 200, 54)
    for u, v in zip(got, again):
        assert u is None or torch.equal(u, v)


@pytest.mark.parametrize("mode", GROUP_MODES)
def test_group_form_deterministic(dev, mode):
    """Two launches at whisper-small 8x, 4096 rows, give the same bits in
    every output, the loss included."""
    a, _ = _group_call(mode, 768, 6144, 0, 4096, 4096, 55)
    b, _ = _group_call(mode, 768, 6144, 0, 4096, 4096, 55)
    for u, v in zip(a, b):
        assert u is None or torch.equal(u, v)


@pytest.mark.parametrize("d,h", [(768, 6144), (384, 24576)])
@pytest.mark.parametrize("mode", ["kernel_a", "skip_transcoder"])
def test_wide_dispatch_names_the_form(dev, mode, d, h):
    """The wide routes launch the select-and-decode ``_build.wide_form``
    names at each width (the group form at whisper-small 8x, the CTA-per-
    row form at whisper-tiny 64x), once a chunk, and no other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {"kernel_a": WIDE_SELECT,
             "skip_transcoder": {"group": "coder_select_decode_group_kernel",
                                 "cta": "coder_select_decode_wide_kernel"}}[mode]
    _group_call(mode, d, h, 0, 512, 512, 56)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _group_call(mode, d, h, 0, 512, 512, 56)
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages() for _ in range(e.count)
            if e.device_type == DeviceType.CUDA]
    form = _build.wide_form(h)
    assert form == ("group" if h <= 8192 else "cta")
    assert sum(names[form] in key for key in keys) == 3, keys
    other = names["cta" if form == "group" else "group"]
    assert not any(other in key for key in keys), keys


@pytest.mark.parametrize("d,h,rows", [(768, 6144, 512), (768, 6144, 13569), (384, 24576, 512)])
@pytest.mark.parametrize("mode", GROUP_MODES)
def test_wide_dispatch_counts_the_form(dev, mode, d, h, rows):
    """The library's own count of the select-and-decode launches by form
    (``wst_*_select_launches``, kept where each launch is made): once a
    chunk in the form ``_build.wide_form`` names, none in the other."""
    lib = _build.load_library()
    count = lib.wst_sae_select_launches if mode == "kernel_a" else lib.wst_coder_select_launches
    before = [count(0), count(1)]
    _group_call(mode, d, h, 0, rows, rows, 60)
    torch.cuda.synchronize()
    chunks = -(-rows // _build.topk_encode_chunk_rows(h))
    made = [count(0) - before[0], count(1) - before[1]]
    assert made == ([chunks, 0] if _build.wide_form(h) == "group" else [0, chunks])
    assert count(2) == -1


def test_group_form_refuses_misaligned_w_dec(dev):
    """The group form reads W_dec as bf16 pairs: both wrappers refuse a
    W_dec not 4-byte aligned."""
    p, x = _params(57, 768, 6144), _rows(58, 16, 768)
    we_t, b_enc, b_pre, wd, b_out = _wide_args(p)
    odd = torch.empty(wd.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view_as(wd)
    odd.copy_(wd)
    with pytest.raises(ValueError, match="w_dec must be 4-byte aligned"):
        cuda_sae._fused_loss_launch(x, 0, 16, we_t, b_enc, b_pre, odd, b_out, K, True)
    xs, ys, ops, k = _coder_inputs("topk_transcoder", 16, 59, modes=WIDE_CODER_MODES)
    odd = torch.empty(ops.wd.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view_as(ops.wd)
    odd.copy_(ops.wd)
    with pytest.raises(ValueError, match="w_dec must be 4-byte aligned"):
        CC._coder_launch(xs, ys, 0, 16, ops._replace(wd=odd), k, True)
