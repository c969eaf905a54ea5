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
                                          (16, 100, 200)])
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
    p = _params(14, d=384, h=4096)
    x = _rows(15, 16)
    with pytest.raises(ValueError, match="H a multiple of 32"):
        cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    with pytest.raises(ValueError, match="registers"):
        topk_mask_fwd(torch.randn(4, 4096, device=dev), K)
    q = _params(16)
    with pytest.raises(ValueError, match="window"):
        cuda_sae.fused_sae_loss_indexed(x, 1, *(q[n] for n in NAMES), K, 16)
    with pytest.raises(ValueError, match="b_enc must be a contiguous torch.float32"):
        cuda_sae.fused_topk_encode(x, q["w_enc"], q["b_enc"].double(), q["b_pre"], K)
    with pytest.raises(ValueError, match="b_pre must be"):
        cuda_sae.fused_sae_loss(x, q["w_enc"], q["b_enc"], q["b_pre"][:-1], q["w_dec"],
                                q["b_dec"][:-1], K)
