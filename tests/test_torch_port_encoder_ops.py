"""Plain versions of the fused encoder kernels (``ops/encoder.py``) against
the JAX package's Pallas kernels, run in interpret mode as
``tests/test_pallas_encoder.py`` runs them, at its small geometry.

Bar for one bf16 block: max|d| <= 2**-6 * max|ref| and mean|d| <=
2**-9 * mean|ref| (bf16 rounding of the same arithmetic summed in
another order; the Pallas GELU uses an erf polynomial, 3.4e-5 abs, the
port the exact erf).  Each test prints the errors it measured.
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

B, T, D, HEADS, F = 2, 100, 128, 2, 256
T_PAD = 128
BF = jnp.bfloat16
BLOCK_MAX, BLOCK_MEAN = 2.0**-6, 2.0**-9

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs one worker process per core: keep torch's intra-op
    pool to one thread here, or the workers' pools oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def close(got, want, max_rel=BLOCK_MAX, mean_rel=BLOCK_MEAN, what=""):
    """The bar above; ``got`` a tensor, ``want`` a jax/numpy array."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    d = np.abs(g - w)
    mx, mn = float(d.max() / np.abs(w).max()), float(d.mean() / np.abs(w).mean())
    print(f"{what}: max rel {mx:.3g}, mean rel {mn:.3g}")
    assert mx <= max_rel and mn <= mean_rel, (what, mx, mn)


def to_torch(a) -> torch.Tensor:
    return TW.params_from_jax({"a": np.asarray(a)})["a"]


@pytest.fixture(scope="module")
def layer():
    """One bf16 encoder layer (weights with nonzero biases and LN
    params) and a bf16 input, in both packages."""
    arch = JW.WhisperArch(d_model=D, encoder_layers=1, decoder_layers=1,
                          num_heads=HEADS, ffn_dim=F, max_source_positions=T)
    params = JW.init_whisper(jax.random.PRNGKey(0), arch)
    noise = jax.random.PRNGKey(7)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(noise, a.shape), params)
    enc16 = jax.tree_util.tree_map(lambda a: a.astype(BF), params["encoder"])
    lp = jax.tree_util.tree_map(lambda a: a[0], enc16["layers"])
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, D), jnp.float32).astype(BF)
    tenc = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, enc16))
    return {"enc": enc16, "lp": lp, "x": x, "tenc": tenc, "tlp": TW._layer(tenc["layers"], 0),
            "tx": to_torch(x)}


def _pad(x, t_pad=T_PAD):
    return jnp.pad(x, ((0, 0), (0, t_pad - T), (0, 0)))


def test_conv_stem_matches_pallas(layer):
    enc = layer["enc"]
    mel = (jax.random.normal(jax.random.PRNGKey(5), (B, 80, 2 * T)) * 0.5).astype(BF)
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_conv_stem(mel, enc, T_PAD)[:, :T]
    te = layer["tenc"]
    got = E.conv_stem_plain(to_torch(mel), te["conv1_w"], te["conv1_b"], te["conv2_w"],
                            te["conv2_b"], te["pos"])
    assert got.dtype == torch.bfloat16
    close(got, want, what="conv stem")


def test_attention_block_matches_pallas_full_body(layer):
    """The full (whole-sequence) body on a padded input: every row,
    pad rows included, agrees and stays finite."""
    lp, tlp = layer["lp"], layer["tlp"]
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_attention_block(_pad(layer["x"]), lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                        n_heads=HEADS, t_real=T)
    got = E.attention_block_plain(to_torch(_pad(layer["x"])), tlp["ln1_g"], tlp["ln1_b"],
                                  tlp["attn"], HEADS, t_real=T)
    assert got.shape == (B, T_PAD, D) and got.dtype == torch.bfloat16
    close(got, want, what="attention block (full body)")


def test_attention_block_matches_pallas_tiled_body(layer, monkeypatch):
    """The query-row-tiled body, two tiles engaged (``WST_ATTENTION_TQ``)."""
    lp, tlp = layer["lp"], layer["tlp"]
    monkeypatch.setenv("WST_ATTENTION_TQ", str(T_PAD))
    monkeypatch.setattr(pe, "attention_supported", lambda *a: False)
    xp = _pad(layer["x"], 2 * T_PAD)
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_attention_block(xp, lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                        n_heads=HEADS, t_real=T)
    got = E.attention_block_plain(to_torch(xp), tlp["ln1_g"], tlp["ln1_b"], tlp["attn"], HEADS,
                                  t_real=T)
    close(got, want, what="attention block (tiled body)")


@pytest.mark.parametrize("capture,final_ln,cap_dt", [
    (False, False, BF), (True, False, BF), (False, True, BF), (True, True, jnp.float32),
])
def test_mlp_block_matches_pallas(layer, capture, final_ln, cap_dt):
    lp, tlp = layer["lp"], layer["tlp"]
    rng = np.random.default_rng(9)
    fg = rng.standard_normal(D).astype(np.float32)
    fb = rng.standard_normal(D).astype(np.float32)
    flat = layer["x"].reshape(B * T, D)
    fl = (jnp.asarray(fg), jnp.asarray(fb)) if final_ln else None
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_mlp_block(flat, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture=capture,
                                  final_ln=fl, capture_dtype=cap_dt)
    tdt = torch.float32 if cap_dt == jnp.float32 else torch.bfloat16
    got = E.mlp_block_plain(layer["tx"].reshape(B * T, D), tlp["ln2_g"], tlp["ln2_b"],
                            tlp["mlp"], capture=capture,
                            final_ln=(torch.from_numpy(fg), torch.from_numpy(fb)) if final_ln
                            else None, capture_dtype=tdt)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == 1 + final_ln + 2 * capture
    names = ["out"] + ["ln_f(out)"] * final_ln + ["mlp_in", "mlp_out"] * capture
    for name, g, w in zip(names, got, want):
        assert g.dtype == (tdt if name == "ln_f(out)" else torch.bfloat16), name
        close(g, w, what=f"mlp {name}")


def _jax_attention_core(q, k, v, heads):
    """The core of the JAX composed ``_attention`` (models/whisper.py:190-205)
    on folded ``[B, T, D]`` q, k, v."""
    b, t, d = q.shape
    hd = d // heads
    qh, kh, vh = (a.reshape(b, t, heads, hd).transpose(0, 2, 1, 3) for a in (q, k, v))
    scores = jnp.einsum("bhqd,bhkd->bhqk", qh, kh, preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(scores, axis=-1).astype(vh.dtype)
    out = jnp.einsum("bhqk,bhkd->bhqd", attn, vh)
    return out.transpose(0, 2, 1, 3).reshape(b, t, d)


def test_self_attention_plain_matches_jax_core():
    """q, k, v as a layer gives them: v carries a per-column offset (the
    v bias), so the averages are not pure cancellation."""
    t = 300  # the length at which the flash route engages
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((B, t, D)).astype(np.float32) for _ in range(3))
    v = v + rng.standard_normal(D).astype(np.float32)
    q, k, v = (jnp.asarray(a).astype(BF) for a in (q * 0.125, k, v))
    want = _jax_attention_core(q, k, v, HEADS)
    got = E.self_attention_plain(to_torch(q), to_torch(k), to_torch(v), HEADS)
    close(got, want, what="attention core")


def test_dispatch_uses_plain_versions_on_cpu(layer):
    """A CPU tensor goes to the plain version (and counts as such);
    another device raises."""
    E.plain_calls.clear()
    tlp = layer["tlp"]
    got = E.attention_block(layer["tx"], tlp["ln1_g"], tlp["ln1_b"], tlp["attn"], HEADS)
    want = E.attention_block_plain(layer["tx"], tlp["ln1_g"], tlp["ln1_b"], tlp["attn"], HEADS)
    assert torch.equal(got, want)
    assert E.plain_calls["self_attention"] == 2
    meta = torch.empty((B, T, D), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        E.mlp_block(meta.reshape(B * T, D), tlp["ln2_g"], tlp["ln2_b"], tlp["mlp"])
    with pytest.raises(ValueError, match="unsupported device"):
        E.flash_self_attention(meta, meta, meta, HEADS)
