"""The encoder's whisper-large geometry on the CPU: the plain versions of
the wide conv stem (128 mels, D=1280) and the wide MLP block (D=1280,
F=5120, all four output modes), and the attention block at 20 heads,
against the JAX package's Pallas kernels in interpret mode, at a small T;
and the fused route's gate against ``pallas_encoder.supported``.

Bar for one bf16 block, as in ``tests/test_torch_port_encoder_ops.py``:
max|d| <= 2**-6 * max|ref| and mean|d| <= 2**-9 * mean|ref| (bf16
rounding of the same arithmetic summed in another order; the Pallas GELU
uses an erf polynomial, 3.4e-5 abs, the port the exact erf).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.ops import pallas_encoder as pe
from whisper_sae_tpu_torch.models import whisper as TW
from whisper_sae_tpu_torch.ops import encoder as E

D, HEADS, F, N_MELS = 1280, 20, 5120, 128
B, T = 1, 128  # conv stem and MLP rows: 128 frames of one clip
T_ATT, T_PAD = 200, 256  # attention: two 128-row query tiles, 56 padded rows
BF = jnp.bfloat16
BLOCK_MAX, BLOCK_MEAN = 2.0**-6, 2.0**-9
WHISPERS = ("openai/whisper-tiny", "openai/whisper-base", "openai/whisper-small",
            "openai/whisper-medium", "openai/whisper-large", "openai/whisper-large-v2",
            "openai/whisper-large-v3")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what=""):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    d = np.abs(g - w)
    mx, mn = float(d.max() / np.abs(w).max()), float(d.mean() / np.abs(w).mean())
    print(f"{what}: max rel {mx:.3g}, mean rel {mn:.3g}")
    assert mx <= BLOCK_MAX and mn <= BLOCK_MEAN, (what, mx, mn)


def to_torch(a) -> torch.Tensor:
    return TW.params_from_jax({"a": np.asarray(a)})["a"]


@pytest.fixture(scope="module")
def layer():
    """One bf16 whisper-large-v3-width encoder layer (weights, biases and
    LN parameters all perturbed) in both packages."""
    arch = JW.WhisperArch(d_model=D, encoder_layers=1, decoder_layers=1, num_heads=HEADS,
                          ffn_dim=F, n_mels=N_MELS, max_source_positions=T_ATT)
    params = JW.init_whisper(jax.random.PRNGKey(0), arch)
    keys = iter(jax.random.split(jax.random.PRNGKey(7), 64))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(next(keys), a.shape), params)
    enc16 = jax.tree_util.tree_map(lambda a: a.astype(BF), params["encoder"])
    tenc = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, enc16))
    return {"enc": enc16, "lp": jax.tree_util.tree_map(lambda a: a[0], enc16["layers"]),
            "tenc": tenc, "tlp": TW._layer(tenc["layers"], 0)}


def test_wide_conv_stem_matches_pallas(layer):
    """128 mels into D=1280 (the stem's wide form on the card)."""
    enc, te = layer["enc"], layer["tenc"]
    mel = (jax.random.normal(jax.random.PRNGKey(5), (B, N_MELS, 2 * T)) * 0.5).astype(BF)
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_conv_stem(mel, enc, T)
    got = E.conv_stem_plain(to_torch(mel), te["conv1_w"], te["conv1_b"], te["conv2_w"],
                            te["conv2_b"], te["pos"])
    assert got.shape == (B, T, D) and got.dtype == torch.bfloat16
    close(got, want, "wide conv stem")


@pytest.mark.parametrize("capture,final_ln,cap_dt", [
    (False, False, BF), (True, False, BF), (False, True, BF), (True, True, jnp.float32),
], ids=["plain", "capture", "final_ln_bf16", "both_f32"])
def test_wide_mlp_block_matches_pallas(layer, capture, final_ln, cap_dt):
    """D=1280, F=5120 on 128 rows, in all four output modes."""
    lp, tlp = layer["lp"], layer["tlp"]
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((B * T, D)).astype(np.float32)).astype(BF)
    fg, fb = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    fl = (jnp.asarray(fg), jnp.asarray(fb)) if final_ln else None
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_mlp_block(x, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture=capture,
                                  final_ln=fl, capture_dtype=cap_dt)
    tdt = torch.float32 if cap_dt == jnp.float32 else torch.bfloat16
    got = E.mlp_block_plain(to_torch(x), tlp["ln2_g"], tlp["ln2_b"], tlp["mlp"],
                            capture=capture,
                            final_ln=(torch.from_numpy(fg), torch.from_numpy(fb)) if final_ln
                            else None, capture_dtype=tdt)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == 1 + final_ln + 2 * capture
    names = ["out"] + ["ln_f(out)"] * final_ln + ["mlp_in", "mlp_out"] * capture
    for name, g, w in zip(names, got, want):
        assert g.dtype == (tdt if name == "ln_f(out)" else torch.bfloat16), name
        close(g, w, f"wide mlp {name}")


def test_attention_block_20_heads_matches_pallas_tiled_body(layer, monkeypatch):
    """20 heads of 64 (whisper-large), the query-row-tiled body that
    whisper-large takes on the TPU, two 128-row tiles, keys past 200
    masked."""
    lp, tlp = layer["lp"], layer["tlp"]
    monkeypatch.setenv("WST_ATTENTION_TQ", "128")
    monkeypatch.setattr(pe, "attention_supported", lambda *a: False)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T_ATT, D), jnp.float32).astype(BF)
    xp = jnp.pad(x, ((0, 0), (0, T_PAD - T_ATT), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_attention_block(xp, lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                        n_heads=HEADS, t_real=T_ATT)
    got = E.attention_block_plain(to_torch(xp), tlp["ln1_g"], tlp["ln1_b"], tlp["attn"], HEADS,
                                  t_real=T_ATT)
    assert got.shape == (B, T_PAD, D)
    close(got[:, :T_ATT], np.asarray(want, np.float32)[:, :T_ATT], "attention block, 20 heads")


def _jax_gate(monkeypatch, t: int, d: int, heads: int) -> bool:
    """``pallas_encoder.supported`` as the JAX route asks it on the TPU."""
    monkeypatch.setattr(pe.jax, "default_backend", lambda: "tpu")
    return pe.supported(-(-t // 128) * 128, d, heads)


@pytest.mark.parametrize("name", WHISPERS)
def test_fused_route_gate_matches_jax_for_every_whisper(monkeypatch, name):
    arch = TW.arch_for(name)
    jarch = JW.arch_for(name)
    assert (arch.d_model, arch.num_heads) == (jarch.d_model, jarch.num_heads)
    t = arch.max_source_positions
    assert E.fused_encoder_supported(t, arch.d_model, arch.num_heads)
    assert _jax_gate(monkeypatch, t, arch.d_model, arch.num_heads)


@pytest.mark.parametrize("t,d,heads", [(1500, 1664, 26), (1500, 1600, 25), (2100, 1280, 20),
                                       (1500, 1344, 21)])
def test_fused_route_gate_refuses_what_jax_refuses(monkeypatch, t, d, heads):
    """Wider than 1536, D not a multiple of 128, or T past 2048 rows:
    the JAX package composes, and so does the port."""
    assert not _jax_gate(monkeypatch, t, d, heads)
    assert not E.fused_encoder_supported(t, d, heads)


def test_encoder_forward_composes_outside_the_gate(monkeypatch):
    """A bf16 mel whose geometry fails the gate takes the composed route
    (no plain fused-block call), one inside it takes the fused blocks."""
    arch = TW.WhisperArch(128, 1, 1, 2, 256, max_source_positions=100)
    params = TW.cast_params(TW.init_whisper(torch.Generator().manual_seed(0), arch),
                            torch.bfloat16)
    mel = (torch.randn(1, 80, 200, generator=torch.Generator().manual_seed(1)) * 0.5).bfloat16()
    E.plain_calls.clear()
    fused_last, _ = TW.encoder_forward(params, mel, arch)
    assert E.plain_calls["conv_stem"] == 1 and E.plain_calls["mlp_block"] == 1
    monkeypatch.setattr(E, "MAX_D", 64)  # the same model, now outside the gate
    E.plain_calls.clear()
    composed_last, _ = TW.encoder_forward(params, mel, arch)
    assert sum(E.plain_calls.values()) == 0
    d = (fused_last.float() - composed_last.float()).abs()
    assert float(d.max() / composed_last.float().abs().max()) <= 2.0**-4
