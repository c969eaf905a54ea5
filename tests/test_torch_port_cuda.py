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


GEOMS = [(128, 2, 256, 80, 100), (384, 6, 1536, 80, 1500), (384, 6, 1536, 128, 1500)]


@pytest.mark.parametrize("d,heads,f,n_mels,t", GEOMS)
def test_encoder_kernels_match_plain(dev, d, heads, f, n_mels, t):
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


@pytest.mark.parametrize("capture,final_ln,cap_dt", [
    (False, False, torch.bfloat16), (True, False, torch.bfloat16),
    (False, True, torch.bfloat16), (True, True, torch.float32),
])
def test_mlp_kernel_all_modes(dev, capture, final_ln, cap_dt):
    enc, lp, g = _encoder(384, 6, 1536, 80, 1500, seed=1)
    x = torch.randn(3000, 384, generator=g).to(dev).bfloat16()
    fl = (enc["ln_f_g"].float(), enc["ln_f_b"].float()) if final_ln else None
    got = CE.mlp_block_fwd(x, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
    want = E.mlp_block_plain(x, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
    got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
    assert len(got) == len(want) == 1 + final_ln + 2 * capture
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _close(a, b)


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
                      None if w_skip is None else w_skip.to(device))
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
                                     torch.zeros(3072, 384, device=dev), ops.b_out), k)
    with pytest.raises(ValueError, match="window"):
        CC._coder_launch(x, y, 32, 64, ops, k)
    with pytest.raises(ValueError, match="b_enc must be"):
        CC._coder_launch(x, y, 0, 64, ops._replace(b_enc=ops.b_enc.double()), k)
