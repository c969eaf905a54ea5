"""The conv stem's card route written out in plain PyTorch
(``ops/encoder.py:conv_stem_route_plain``: the padded time-major mel,
conv1 as three tap products over frames f + j with the GELU epilogue into
a hidden whose row 0 is h[-1] = 0, conv2 as three tap products over the
hidden's rows 2t + j, then the GELU and positions epilogue) against the
JAX package's Pallas ``fused_conv_stem`` in interpret mode, as
``tests/test_torch_port_encoder_ops.py`` runs it, and against the port's
``conv_stem_plain`` (the six shifted even/odd products).

Geometries: whisper-tiny's 80 mels into D=384 and whisper-large-v3's 128
mels into D=1280 at T=100 output frames, so conv1's 200 rows and conv2's
100 end inside a 128-row tile, and 80 mels into D=128 at T=70; two clips
(a clip boundary).  Inputs are made with numpy from a seed and rounded to
bf16 alike in both packages.

Bar for one bf16 block (``test_torch_port_encoder_ops.py:28``): max|d| <=
2**-6 * max|ref| and mean|d| <= 2**-9 * mean|ref| (bf16 rounding of the
same arithmetic summed in another order; the Pallas GELU uses an erf
polynomial, 3.4e-5 abs, the port the exact erf).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_encoder as pe
from whisper_sae_tpu_torch.ops import encoder as E

B, T_PAD = 2, 128
BLOCK_MAX, BLOCK_MEAN = 2.0**-6, 2.0**-9
GEOMS = {  # name: (n_mels, D, T output frames)
    "tiny_80_mels": (80, 384, 100),
    "large_v3_128_mels": (128, 1280, 100),
    "narrow_80_mels_t70": (80, 128, 70),
}


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


def _inputs(n_mels: int, d: int, t: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The stem's weights, positions and a mel batch, f32 values that are
    exact in bf16."""
    rng = np.random.default_rng(seed)
    raw = {
        "mel": rng.standard_normal((B, n_mels, 2 * t)) * 0.5,
        "conv1_w": rng.standard_normal((d, n_mels, 3)) * (3 * n_mels) ** -0.5,
        "conv1_b": rng.standard_normal(d) * 0.1,
        "conv2_w": rng.standard_normal((d, d, 3)) * (3 * d) ** -0.5,
        "conv2_b": rng.standard_normal(d) * 0.1,
        "pos": rng.standard_normal((t, d)) * 0.1,
    }
    return {k: torch.from_numpy(v.astype(np.float32)).bfloat16().float().numpy()
            for k, v in raw.items()}


def _torch_args(a: dict[str, np.ndarray]) -> tuple:
    return tuple(torch.from_numpy(a[k]).bfloat16()
                 for k in ("mel", "conv1_w", "conv1_b", "conv2_w", "conv2_b", "pos"))


@pytest.mark.parametrize("geom", GEOMS)
def test_stem_route_matches_pallas(geom):
    n_mels, d, t = GEOMS[geom]
    a = _inputs(n_mels, d, t)
    enc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in a.items() if k != "mel"}
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_conv_stem(jnp.asarray(a["mel"], jnp.bfloat16), enc, T_PAD)[:, :t]
    got = E.conv_stem_route_plain(*_torch_args(a))
    assert got.shape == (B, t, d) and got.dtype == torch.bfloat16
    close(got, want, f"stem route vs Pallas, {geom}")


@pytest.mark.parametrize("geom", GEOMS)
def test_stem_route_matches_plain(geom):
    n_mels, d, t = GEOMS[geom]
    args = _torch_args(_inputs(n_mels, d, t, seed=1))
    got = E.conv_stem_route_plain(*args)
    assert got.dtype == torch.bfloat16
    close(got, E.conv_stem_plain(*args).float(), f"stem route vs conv_stem_plain, {geom}")
