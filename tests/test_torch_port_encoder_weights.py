"""The encoder kernels' weight layouts (``ops/cuda_encoder.py``), built once
per parameter tensor, on the CPU.

The wrappers hand the kernels ``[N, K]`` bf16 weights and f32 biases and
LN vectors; ``prepared`` builds them once per source tensors and
rebuilds them after an in-place update.  These tests check the layouts
against the parameters, that the kernels' arithmetic on them (emulated
here in f32) is the plain version's, the cache's hits and rebuilds,
that an entry goes with the weights it was built from, and that the
wrappers refuse CPU, non-bf16 and too-narrow inputs before they load the
kernel library.  Layouts are exact; the emulated
products are f32 sums of the same bf16 operands in another order
(rtol 1e-5 before the one bf16 rounding, so compared at one bf16 ulp).
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

from whisper_sae_tpu_torch.models import whisper as W
from whisper_sae_tpu_torch.ops import _build
from whisper_sae_tpu_torch.ops import cuda_encoder as CE
from whisper_sae_tpu_torch.ops import encoder as E

D, HEADS, F, N_MELS, ROWS = 128, 2, 256, 80, 37


@pytest.fixture(autouse=True)
def _fresh_cache():
    CE._prepared.clear()
    yield
    CE._prepared.clear()


def _bf(rng, *shape, scale=0.05):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


def _encoder(dtype=torch.bfloat16) -> dict:
    arch = W.WhisperArch(d_model=D, encoder_layers=2, decoder_layers=1, num_heads=HEADS,
                         ffn_dim=F, n_mels=N_MELS, max_source_positions=100)
    g = torch.Generator().manual_seed(0)
    p = W.init_whisper(g, arch)["encoder"]
    p = W._tree_map(lambda a: a + 0.05 * torch.randn(a.shape, generator=g), p)
    return W.cast_params(p, dtype)


@pytest.fixture
def enc():
    """A bf16 two-layer encoder at D=128 with every parameter randomised,
    its layers as the model reads them (views of the stacked tensors)."""
    return _encoder()


def test_qkv_weights_layout(enc):
    lp = W._layer(enc["layers"], 0)
    a = lp["attn"]
    wt, bias, g, b = CE.qkv_weights(a, lp["ln1_g"], lp["ln1_b"])
    assert wt.dtype == torch.bfloat16 and wt.is_contiguous() and wt.shape == (3 * D, D)
    assert torch.equal(wt, torch.cat([a["wq"].t(), a["wk"].t(), a["wv"].t()]).bfloat16())
    assert bias.dtype == torch.float32 and bias.shape == (3 * D,)
    assert torch.equal(bias, torch.cat([a["bq"].float(), torch.zeros(D), a["bv"].float()]))
    assert torch.equal(g, lp["ln1_g"].float()) and torch.equal(b, lp["ln1_b"].float())
    assert g.dtype == b.dtype == torch.float32


def test_out_proj_and_mlp_weights_layout(enc):
    lp = W._layer(enc["layers"], 1)
    wt, bias = CE.out_proj_weights(lp["attn"]["wo"], lp["attn"]["bo"])
    assert torch.equal(wt, lp["attn"]["wo"].t().bfloat16()) and wt.is_contiguous()
    assert torch.equal(bias, lp["attn"]["bo"].float())
    m = lp["mlp"]
    w1t, b1, w2t, b2, g, b = CE.mlp_weights(m, lp["ln2_g"], lp["ln2_b"])
    assert w1t.shape == (F, D) and w2t.shape == (D, F)
    assert torch.equal(w1t, m["w1"].t()) and torch.equal(w2t, m["w2"].t())
    assert w1t.is_contiguous() and w2t.is_contiguous()
    assert all(t.dtype == torch.float32 for t in (b1, b2, g, b))
    assert torch.equal(b1, m["b1"].float()) and torch.equal(g, lp["ln2_g"].float())


def test_stem_weights_layout(enc):
    t = 50
    w1t, b1, w2t, b2, pos = CE.stem_weights(enc["conv1_w"], enc["conv1_b"], enc["conv2_w"],
                                            enc["conv2_b"], enc["pos"][:t])
    assert w1t.shape == (D, 3 * N_MELS) and w2t.shape == (D, 3 * D)
    for j in range(3):
        assert torch.equal(w1t[:, j * N_MELS:(j + 1) * N_MELS], enc["conv1_w"][:, :, j])
        assert torch.equal(w2t[:, j * D:(j + 1) * D], enc["conv2_w"][:, :, j])
    assert torch.equal(pos, enc["pos"][:t].bfloat16()) and pos.shape == (t, D)
    assert b1.dtype == b2.dtype == torch.float32


def _ulp_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal within one bf16 ulp of each value (the emulation sums in
    another order than the plain version before the one rounding)."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape
    assert bool(((g - w).abs() <= 2.0**-7 * w.abs() + 1e-6).all())


def test_kernel_arithmetic_on_the_prepared_weights_is_the_plain_version(enc):
    """What the GEMM's epilogues compute from the prepared operands
    (``encoder_gemm.cu``: q/k/v split by thirds of the stacked product, the
    bias (bq, 0, bv), the scale on q only; the residual epilogue's two
    roundings) reproduces ``ln_qkv_plain`` and ``out_proj_plain``."""
    rng = np.random.default_rng(1)
    lp = W._layer(enc["layers"], 0)
    x = _bf(rng, ROWS, D, scale=1.0)
    wt, bias, g, b = CE.qkv_weights(lp["attn"], lp["ln1_g"], lp["ln1_b"])
    xln = E.ln_f32(x.float(), g, b).bfloat16()  # ln_rows_kernel
    acc = xln.float() @ wt.float().t() + bias
    scale = float(D // HEADS) ** -0.5
    got = (acc[:, :D] * scale, acc[:, D:2 * D], acc[:, 2 * D:])
    for a, w in zip(got, E.ln_qkv_plain(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], HEADS)):
        _ulp_close(a.bfloat16(), w)
    attn = _bf(rng, ROWS, D, scale=1.0)
    wt, bias = CE.out_proj_weights(lp["attn"]["wo"], lp["attn"]["bo"])
    y = (attn.float() @ wt.float().t() + bias).bfloat16()
    _ulp_close((x.float() + y.float()).bfloat16(),
               E.out_proj_plain(attn, x, lp["attn"]["wo"], lp["attn"]["bo"]))


@pytest.mark.parametrize("kind", ["qkv", "out_proj", "mlp", "stem"])
def test_second_call_returns_the_cached_tensors(enc, kind):
    """Each layer's views are new tensor objects every call (``_layer``),
    yet the second call returns the first call's tensors."""
    def get():
        lp = W._layer(enc["layers"], 1)
        if kind == "qkv":
            return CE.qkv_weights(lp["attn"], lp["ln1_g"], lp["ln1_b"])
        if kind == "out_proj":
            return CE.out_proj_weights(lp["attn"]["wo"], lp["attn"]["bo"])
        if kind == "mlp":
            return CE.mlp_weights(lp["mlp"], lp["ln2_g"], lp["ln2_b"])
        return CE.stem_weights(enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"],
                               enc["pos"][:50])

    first, second = get(), get()
    assert len(first) == len(second) and all(a is b for a, b in zip(first, second))
    assert len(CE._prepared) == 1


def test_layers_get_their_own_entries(enc):
    lps = [W._layer(enc["layers"], i) for i in (0, 1)]
    w0, w1 = (CE.qkv_weights(lp["attn"], lp["ln1_g"], lp["ln1_b"])[0] for lp in lps)
    assert len(CE._prepared) == 2 and not torch.equal(w0, w1)


@pytest.mark.parametrize("name", ["wq", "wv", "bq", "ln1_g"])
def test_in_place_update_rebuilds(enc, name):
    lp = W._layer(enc["layers"], 0)
    args = (lp["attn"], lp["ln1_g"], lp["ln1_b"])
    first = CE.qkv_weights(*args)
    src = lp[name] if name.startswith("ln") else lp["attn"][name]
    with torch.no_grad():
        src.add_(1.0)  # in place on the stacked parameter, through the view
    lp = W._layer(enc["layers"], 0)
    second = CE.qkv_weights(lp["attn"], lp["ln1_g"], lp["ln1_b"])
    assert second[0] is not first[0]
    want = _qkv_reference(lp)
    for got, ref in zip(second, want):
        assert torch.equal(got, ref)
    assert len(CE._prepared) == 1  # replaced, not added
    assert all(a is b for a, b in zip(second, CE.qkv_weights(lp["attn"], lp["ln1_g"],
                                                               lp["ln1_b"])))


def _qkv_reference(lp):
    a = lp["attn"]
    d = a["wq"].shape[0]
    return (torch.cat([a["wq"].t(), a["wk"].t(), a["wv"].t()]).bfloat16(),
            torch.cat([a["bq"].float(), torch.zeros(d), a["bv"].float()]),
            lp["ln1_g"].float(), lp["ln1_b"].float())


def _prepare_every_layout(enc) -> None:
    for i in (0, 1):
        lp = W._layer(enc["layers"], i)
        CE.qkv_weights(lp["attn"], lp["ln1_g"], lp["ln1_b"])
        CE.out_proj_weights(lp["attn"]["wo"], lp["attn"]["bo"])
        CE.mlp_weights(lp["mlp"], lp["ln2_g"], lp["ln2_b"])
    CE.stem_weights(enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"],
                    enc["pos"][:50])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropped_encoder_releases_its_entries(dtype):
    """Once the encoder's weights are freed, their entries and kernel
    layouts go too: the cache keeps neither alive (a caller that casts the
    weights for every batch leaves nothing behind).  In f32 the biases and
    LN vectors are their own layout, and in bf16 the positions: the entry
    holds copies of those, not the sources."""
    enc = _encoder(dtype)
    _prepare_every_layout(enc)
    assert len(CE._prepared) == 7
    stacked = weakref.ref(enc["layers"]["attn"]["wq"])
    built = [weakref.ref(t) for _, out in CE._prepared.values() for t in out]
    del enc
    gc.collect()
    assert stacked() is None
    assert len(CE._prepared) == 0 and all(r() is None for r in built)


def test_entry_outlives_the_views_it_was_built_from(enc):
    """The entries follow the stacked tensors, not the per-call views:
    the views die after each call, the entry stays until the stack goes."""
    _prepare_every_layout(enc)
    gc.collect()
    assert len(CE._prepared) == 7
    del enc["layers"]
    gc.collect()
    assert [k[0] for k in CE._prepared] == ["stem"]


def test_inference_tensors_are_built_every_call():
    with torch.inference_mode():
        wo, bo = torch.ones(8, 8, dtype=torch.bfloat16), torch.zeros(8, dtype=torch.bfloat16)
        first = CE.out_proj_weights(wo, bo)
        second = CE.out_proj_weights(wo, bo)
    assert first[0] is not second[0] and torch.equal(first[0], second[0])
    assert len(CE._prepared) == 0


def test_gemm_alignment_constant_is_the_route_gate():
    """The fused route only admits widths the encoder GEMM takes: the
    multiples of its 128-wide tile (``CE._GEMM_WIDTH``)."""
    assert CE._GEMM_WIDTH == 128
    for d in range(64, E.MAX_D + 1, 64):
        assert E.fused_encoder_supported(1500, d, d // 64) == (d % CE._GEMM_WIDTH == 0), d
    assert not E.fused_encoder_supported(1500, 320, 5)


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load_library", refuse)


def _layer_args(enc):
    return W._layer(enc["layers"], 0)


def _call_both(x, lp):
    with pytest.raises(ValueError) as e1:
        CE.ln_qkv_fwd(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], HEADS)
    with pytest.raises(ValueError) as e2:
        CE.out_proj_fwd(x, x, lp["attn"]["wo"], lp["attn"]["bo"])
    return str(e1.value), str(e2.value)


@pytest.mark.parametrize("device,dtype", [("cpu", torch.bfloat16), ("cpu", torch.float32),
                                          ("meta", torch.bfloat16)])
def test_wrappers_refuse_non_cuda_before_loading_the_library(enc, no_library, device, dtype):
    """``ln_qkv_fwd`` and ``out_proj_fwd`` raise a ValueError on a tensor
    that is not a bf16 CUDA tensor before they load (or build) the kernel
    library."""
    x = torch.empty(ROWS, D, dtype=dtype, device=device)
    for msg in _call_both(x, _layer_args(enc)):
        assert "bfloat16 CUDA tensor" in msg


def test_wrappers_refuse_narrow_widths_before_loading_the_library(enc, no_library,
                                                                  monkeypatch):
    """A width that is not a multiple of 128 is refused before the
    library loads (the device check is waived here: no card)."""
    monkeypatch.setattr(CE, "_check_rows", lambda x, what, dims: None)
    x = torch.empty(ROWS, 64, dtype=torch.bfloat16, device="meta")
    for msg in _call_both(x, _layer_args(enc)):
        assert "multiple of 128" in msg


def test_stem_and_mlp_wrappers_refuse_cpu_before_loading_the_library(enc, no_library):
    lp = _layer_args(enc)
    mel = torch.zeros(1, N_MELS, 200, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        CE.conv_stem_fwd(mel, enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"],
                         enc["pos"])
    with pytest.raises(ValueError, match="CUDA"):
        CE.mlp_block_fwd(torch.zeros(ROWS, D, dtype=torch.bfloat16), lp["ln2_g"], lp["ln2_b"],
                         lp["mlp"])
