"""The MLP block's plain version (``ops/encoder.py:mlp_block_plain``) against
the JAX package's Pallas ``fused_mlp_block``, run in interpret mode as
``tests/test_pallas_encoder.py`` runs it, at every width of the fused
route's gate that the other CPU tests do not reach: D in {128, 256, 512,
768, 1024, 1536}, F = 4D, on 64 rows made with numpy from a seed, in all
four output modes.  On the card one route (LN2, fc1 with GELU and fc2
with the residual on the Hopper GEMM, the final-LN capture) serves all
these widths, and ``chip_smoke.py`` holds it to this plain version at
each of them.

Bar for one bf16 block, as in ``tests/test_torch_port_encoder_ops.py``:
max|d| <= 2**-6 * max|ref| and mean|d| <= 2**-9 * mean|ref| (bf16
rounding of the same arithmetic summed in another order; the Pallas GELU
uses an erf polynomial, 3.4e-5 abs, the port the exact erf).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_encoder as pe
from whisper_sae_tpu_torch.ops import encoder as E

ROWS = 64
WIDTHS = (128, 256, 512, 768, 1024, 1536)
BLOCK_MAX, BLOCK_MEAN = 2.0**-6, 2.0**-9


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (kept as f32), the values both packages get."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(d: int):
    rng = np.random.default_rng(d)
    f = 4 * d
    arr = {
        "x": rng.standard_normal((ROWS, d)),
        "ln_g": 1 + 0.1 * rng.standard_normal(d), "ln_b": 0.1 * rng.standard_normal(d),
        "w1": rng.standard_normal((d, f)) * d ** -0.5, "b1": 0.1 * rng.standard_normal(f),
        "w2": rng.standard_normal((f, d)) * f ** -0.5, "b2": 0.1 * rng.standard_normal(d),
        "fg": 1 + 0.1 * rng.standard_normal(d), "fb": 0.1 * rng.standard_normal(d),
    }
    return {k: _bf16(v.astype(np.float32)) for k, v in arr.items()}


def _close(got: torch.Tensor, want, what: str) -> None:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    d = np.abs(g - w)
    mx, mn = float(d.max() / np.abs(w).max()), float(d.mean() / np.abs(w).mean())
    print(f"{what}: max rel {mx:.3g}, mean rel {mn:.3g}")
    assert mx <= BLOCK_MAX and mn <= BLOCK_MEAN, (what, mx, mn)


@pytest.mark.parametrize("capture,final_ln,cap_dt", [
    (False, False, jnp.bfloat16), (True, False, jnp.bfloat16), (False, True, jnp.bfloat16),
    (True, True, jnp.float32),
], ids=["plain", "capture", "final_ln_bf16", "both_f32"])
@pytest.mark.parametrize("d", WIDTHS)
def test_mlp_block_plain_matches_pallas_at_every_width(d, capture, final_ln, cap_dt):
    a = _inputs(d)
    j = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in a.items()}
    t = {k: torch.from_numpy(v).bfloat16() for k, v in a.items()}
    p_j = {k: j[k] for k in ("w1", "b1", "w2", "b2")}
    p_t = {k: t[k] for k in ("w1", "b1", "w2", "b2")}
    fl_j = (jnp.asarray(a["fg"]), jnp.asarray(a["fb"])) if final_ln else None
    fl_t = (torch.from_numpy(a["fg"]), torch.from_numpy(a["fb"])) if final_ln else None
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_mlp_block(j["x"], j["ln_g"], j["ln_b"], p_j, capture=capture,
                                  final_ln=fl_j, capture_dtype=cap_dt)
    tdt = torch.float32 if cap_dt == jnp.float32 else torch.bfloat16
    got = E.mlp_block_plain(t["x"], t["ln_g"], t["ln_b"], p_t, capture=capture, final_ln=fl_t,
                            capture_dtype=tdt)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == 1 + final_ln + 2 * capture
    names = ["out"] + ["ln_f(out)"] * final_ln + ["mlp_in", "mlp_out"] * capture
    for name, g, w in zip(names, got, want):
        assert g.dtype == (tdt if name == "ln_f(out)" else torch.bfloat16), name
        _close(g, w, f"D={d} {name}")
