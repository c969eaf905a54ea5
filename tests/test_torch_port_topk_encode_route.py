"""Kernel B's card route written out in plain PyTorch
(``cuda_sae.topk_encode_route_plain``: per chunk of rows the centred bf16
rows, the kPre product, the select's pass loop stopping at a count of
exactly k, the masked relu) and the port's ``fused_topk_encode`` on CPU
tensors, against the JAX package's Pallas encode
(``pallas_sae.fused_topk_encode``, its non-blocked branch) run in
interpret mode, as ``tests/test_torch_port_kernels.py`` runs it; and the
route against ``topk_encode_plain``.

Geometries: D=128, H=256, K=8, and whisper-tiny's full width D=384,
H=3072, K=32.  Rows: 40 in one chunk, and 37 in chunks of 16 (a ragged
last chunk; the JAX kernel in ragged blocks of 8).  Rows in f32 and in
bf16, the latent in bf16 and in f32.

Bars: against the JAX kernel the selection identical and the values
within bf16 rounding (atol 1e-2 * max), as
``test_encode_matches_pallas_interpret``.  Against ``topk_encode_plain``
bit for bit, the plain version called on each chunk's rows: the CPU's
f32 product of a 16-row chunk sums in another order than that of all 37
rows, where the card's GEMM gives each element the same bits in any
chunk (one CTA's fixed K chain), so the route and the plain version are
held to the same product; the selection also against the plain version
on all rows at once.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu_torch.ops import _build, cuda_sae

GEOMETRIES = {"small": (128, 256, 8), "whisper_tiny": (384, 3072, 32)}
ROWS = {"one_chunk": (40, 40), "ragged_chunks": (37, 16)}  # rows, the route's chunk
JAX_BLOCK = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(geometry: str, rows: int, x_dtype: str):
    """Seeded numpy inputs: x [rows, D] (rounded to bf16 when x_dtype is
    bf16), W_enc [D, H], b_enc, b_pre."""
    d, h, k = GEOMETRIES[geometry]
    rng = np.random.default_rng(d + rows)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    p = {"w_enc": (rng.standard_normal((d, h)) * 0.2).astype(np.float32),
         "b_enc": (rng.standard_normal(h) * 0.05).astype(np.float32),
         "b_pre": (rng.standard_normal(d) * 0.05).astype(np.float32)}
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if x_dtype == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    return k, tx, jx, p


_OUT = pytest.mark.parametrize("out", ["bf16", "f32"])
_X = pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
_ROWS = pytest.mark.parametrize("rows", list(ROWS))
_GEOM = pytest.mark.parametrize("geometry", list(GEOMETRIES))


def _dtypes(out: str):
    return (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)


@_OUT
@_X
@_ROWS
@_GEOM
def test_route_and_port_match_pallas_interpret(geometry, rows, x_dtype, out):
    n, chunk = ROWS[rows]
    k, tx, jx, p = _case(geometry, n, x_dtype)
    jdt, tdt = _dtypes(out)
    with pltpu.force_tpu_interpret_mode():
        want = ps.fused_topk_encode(jx, jnp.asarray(p["w_enc"]), jnp.asarray(p["b_enc"]),
                                    jnp.asarray(p["b_pre"]), k, JAX_BLOCK, jdt)
    want = np.asarray(want.astype(jnp.float32))
    tp = {name: torch.from_numpy(v) for name, v in p.items()}
    we_t = cuda_sae._bf16_t(tp["w_enc"])
    route = cuda_sae.topk_encode_route_plain(tx, we_t, tp["b_enc"], tp["b_pre"], k, tdt, chunk)
    port = cuda_sae.fused_topk_encode(tx, tp["w_enc"], tp["b_enc"], tp["b_pre"], k, tdt)
    for got in (route, port):
        assert got.dtype == tdt and got.shape == (n, GEOMETRIES[geometry][1])
        got = got.float().numpy()
        np.testing.assert_array_equal(got > 0, want > 0)  # identical selection
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


@_OUT
@_X
@_ROWS
@_GEOM
def test_route_matches_plain_bit_for_bit(geometry, rows, x_dtype, out):
    n, chunk = ROWS[rows]
    k, tx, _, p = _case(geometry, n, x_dtype)
    tdt = _dtypes(out)[1]
    tp = {name: torch.from_numpy(v) for name, v in p.items()}
    args = (cuda_sae._bf16_t(tp["w_enc"]), tp["b_enc"], tp["b_pre"], k, tdt)
    route = cuda_sae.topk_encode_route_plain(tx, *args, chunk)
    per_chunk = torch.cat([cuda_sae.topk_encode_plain(tx[r0:r0 + chunk], *args)
                           for r0 in range(0, n, chunk)])
    assert torch.equal(route, per_chunk)
    assert torch.equal(route > 0, cuda_sae.topk_encode_plain(tx, *args) > 0)
    assert int((route > 0).sum(dim=1).max()) <= k


@pytest.mark.parametrize("h,rows", [(40960, 2048), (3072, 27264)])
def test_chunk_rule(h, rows):
    """Kernel B's chunk: the rows whose f32 pre fits the blocked encode's
    budget (2048 rows at H = 40960), rounded down to a multiple of 128."""
    assert _build.PRE_BUDGET == 2048 * 40960 * 4
    assert _build.topk_encode_chunk_rows(h) == rows


def test_chunk_rule_every_width():
    for h in range(32, _build.MAX_WIDE_ROW + 1, 32):
        rows = _build.topk_encode_chunk_rows(h)
        assert rows > 0 and rows % 128 == 0, h
        assert rows * h * 4 <= _build.PRE_BUDGET < (rows + 128) * h * 4, h
