"""The top-k encode and mask at every width the JAX package takes, on the CPU.

The port's top-k encode is one route, up to H = 2^20, counted where the
JAX package takes it as kernel B (``pallas_sae.py:_encode_forward``:
wherever bf16 W_enc fits 48 MiB, ``pallas_sae.py:uses_blocked``), else as
the blocked encode (``_encode_forward_blocked``); kernel C takes H up to
262,144 (``pallas_topk.py:supported``).  The route is one chunk loop
whose select takes its form by row width (``_build.select_form``: the
warp select up to 3072, a warp group a row up to 8192, a CTA a row up to
40960, past it the cluster form: a thread-block cluster of CTAs a row),
all with the CTA select's midpoints, counts and early stop
(``ops.topk.cta_threshold``; the group and cluster forms' models, with
their compaction, are ``ops.topk.group_threshold`` and
``ops.topk.cluster_threshold``).

Held here against the JAX package, from numpy-seeded inputs:
  - the dispatch over Whisper's D x expansion grid, and the routes' limits
    against the JAX package's own (its backend check lifted);
  - kernel B's route written out in plain PyTorch
    (``cuda_sae.topk_encode_route_plain``, its chunk and form by width)
    and ``fused_topk_encode`` on CPU tensors against ``_encode_forward``
    in interpret mode at D = 128 and H = 6144, 24576 and 49152 (one of
    each form past the warp select), x in f32 and bf16, the latent in
    bf16 and f32: the selection bit for bit, values within bf16 rounding
    (atol 1e-2 * max), as ``tests/test_torch_port_topk_encode_route.py``;
  - the blocked route against ``_encode_forward_blocked`` in interpret
    mode at whisper-large 16x (past the budget, unpatched) and at H =
    49152 (the cluster form): selection identical, bf16 bit for bit, f32 at
    rtol 1e-6, as ``tests/test_torch_port_large.py``;
  - the select model bit for bit against ``topk_threshold`` /
    ``topk_mask_dense`` at H = 49152, 81920 and 262,144, with the edge
    cases of ``tests/test_torch_port_wide_select.py``; kernel C's plain
    version past 40960 exactly;
  - the chunk rule at every width up to 2^20: at least one row (a
    multiple of 128 where the budget holds 128 or more), and no workspace
    past ``PRE_BUDGET`` plus the chunk's centred rows;
  - a TopK SAE's AMP trainer at D = 128, H = 49152 against the JAX
    package's (its composed loss around the Pallas encode in interpret
    mode) at the bars of ``tests/test_torch_port_trainer.py``: losses at
    rtol 1e-3, parameters at atol 2e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_wide_select import EDGES, _check_select, _edge_rows

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu.ops import pallas_topk
from whisper_sae_tpu.ops import topk as jtopk
from whisper_sae_tpu.training.trainer import SAETrainer as JSAETrainer
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models import crosscoder as txc
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.ops import _build, cuda_sae
from whisper_sae_tpu_torch.ops.topk import plain_calls, topk_mask_dense
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

K = 32
WHISPER_D = (384, 512, 768, 1024, 1280)
EXPANSIONS = (8, 16, 32, 64, 128)
GRID = [(d, e) for d in WHISPER_D for e in EXPANSIONS]
JAX_BLOCK = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tpu_backend(monkeypatch):
    """The JAX package's Pallas gates as on a TPU: its backend check lifted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _encode_case(seed: int, rows: int, d: int, h: int, x_dtype: str = "f32"):
    """Seeded numpy inputs: x [rows, D] (bf16 when x_dtype is bf16), W_enc
    [D, H], b_enc, b_pre."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    p = {"w_enc": (rng.standard_normal((d, h)) * 0.2).astype(np.float32),
         "b_enc": (rng.standard_normal(h) * 0.05).astype(np.float32),
         "b_pre": (rng.standard_normal(d) * 0.05).astype(np.float32)}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if x_dtype == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    return tx, jx, p


def _dtypes(out: str):
    return (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)


def _jax_args(p):
    return (jnp.asarray(p["w_enc"]).astype(jnp.bfloat16), jnp.asarray(p["b_enc"]),
            jnp.asarray(p["b_pre"]))


def _torch_args(p, tx, tdt):
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    return tp, (tx, cuda_sae._bf16_t(tp["w_enc"]), tp["b_enc"], tp["b_pre"], K, tdt)


# ---------------------------------------------------------------------------
# the dispatch and the limits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,e", GRID, ids=[f"D{d}x{e}" for d, e in GRID])
def test_dispatch_matches_jax(d, e, tpu_backend):
    """The port counts the blocked encode exactly where the JAX package
    takes it, and the route's limit holds every width."""
    h = d * e
    blocked = ps.uses_blocked((4096, d), h)
    assert cuda_sae.uses_blocked(d, h) is blocked
    assert ps.supported((4096, d), h)  # the Pallas encode takes every Whisper SAE width
    assert h <= _build.MAX_BLOCKED_ROW
    # the flattened crosscoder encode takes kernel B where JAX's does
    assert txc._encode_fits(d, h) is (not blocked)


def test_limits_match_jax(tpu_backend):
    """The budget's widest row at D = 384 is 65536, as the JAX package's;
    the encode's widest is ``pallas_sae.py:_MAX_H``; kernel C's is
    ``pallas_topk.supported``'s."""
    for h, blocked in ((65536, False), (65536 + 128, True)):
        assert ps.uses_blocked((8, 384), h) is blocked
        assert cuda_sae.uses_blocked(384, h) is blocked
    assert _build.MAX_BLOCKED_ROW == ps._MAX_H
    assert ps.supported((8, 1280), _build.MAX_BLOCKED_ROW)
    assert not ps.supported((8, 1280), _build.MAX_BLOCKED_ROW + 128)
    assert pallas_topk.supported((8, _build.MAX_MASK_ROW))
    assert not pallas_topk.supported((8, _build.MAX_MASK_ROW + 128))


@pytest.mark.parametrize("h,form", [(3072, "warp"), (3104, "group"), (8192, "group"),
                                    (8224, "cta"), (40960, "cta"), (40992, "cluster"),
                                    (1 << 20, "cluster")])
def test_select_form_by_width(h, form):
    assert _build.select_form(h) == form
    assert _build.SELECT_FORMS.index(form) == ("warp", "group", "cta", "cluster").index(form)
    if form != "warp":
        assert _build.wide_form(h) == form


# ---------------------------------------------------------------------------
# kernel B's route against the JAX package's non-blocked encode
# ---------------------------------------------------------------------------

_OUT = pytest.mark.parametrize("out", ["bf16", "f32"])
_X = pytest.mark.parametrize("x_dtype", ["f32", "bf16"])


@_OUT
@_X
@pytest.mark.parametrize("h", [6144, 24576, 49152])
def test_kernel_b_route_matches_pallas_interpret(h, x_dtype, out):
    d, rows = 128, 20
    assert not ps.uses_blocked((rows, d), h)
    tx, jx, p = _encode_case(h + rows, rows, d, h, x_dtype)
    jdt, tdt = _dtypes(out)
    with pltpu.force_tpu_interpret_mode():
        want = ps.fused_topk_encode(jx, jnp.asarray(p["w_enc"]), jnp.asarray(p["b_enc"]),
                                    jnp.asarray(p["b_pre"]), K, JAX_BLOCK, jdt)
    want = np.asarray(want.astype(jnp.float32))
    tp, args = _torch_args(p, tx, tdt)
    assert _build.topk_encode_chunk_rows(h) >= rows  # the route's own chunk: one
    route = cuda_sae.topk_encode_route_plain(*args)
    ragged = cuda_sae.topk_encode_route_plain(*args, 8)  # chunks of 8, 8 and 4
    before = (plain_calls["fused_topk_encode"], plain_calls["fused_topk_encode_blocked"])
    port = cuda_sae.fused_topk_encode(tx, tp["w_enc"], tp["b_enc"], tp["b_pre"], K, tdt)
    assert (plain_calls["fused_topk_encode"], plain_calls["fused_topk_encode_blocked"]) == (
        before[0] + 1, before[1])
    assert torch.equal(ragged > 0, route > 0)
    for got in (route, port):
        assert got.dtype == tdt and got.shape == (rows, h)
        got = got.float().numpy()
        np.testing.assert_array_equal(got > 0, want > 0)  # identical selection
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
        assert ((got > 0).sum(axis=1) == K).all()


# ---------------------------------------------------------------------------
# the blocked route against the JAX package's blocked encode
# ---------------------------------------------------------------------------


@_OUT
@pytest.mark.parametrize("d,h", [(1280, 20480), (128, 49152)], ids=["large_16x", "cluster"])
def test_blocked_route_matches_pallas_interpret(d, h, out):
    """The encode's route (its own chunk, and ragged chunks of 8)
    against ``_encode_forward_blocked`` in interpret mode: at whisper-large
    16x, past the budget, through ``fused_topk_encode``'s dispatch too; at
    H = 49152 (the cluster form) by the kernel itself."""
    rows = 20
    tx, jx, p = _encode_case(d + h, rows, d, h)
    jdt, tdt = _dtypes(out)
    with pltpu.force_tpu_interpret_mode():
        want = ps._encode_forward_blocked(jx, *_jax_args(p), K, JAX_BLOCK, jdt)
    want = np.asarray(want.astype(jnp.float32))
    tp, args = _torch_args(p, tx, tdt)
    route = cuda_sae.topk_encode_route_plain(*args)
    ragged = cuda_sae.topk_encode_route_plain(*args, 8)
    plain = cuda_sae.topk_encode_plain(*args)
    got_all = [route, ragged]
    if ps.uses_blocked((rows, d), h):
        before = plain_calls["fused_topk_encode_blocked"]
        got_all.append(cuda_sae.fused_topk_encode(tx, tp["w_enc"], tp["b_enc"], tp["b_pre"], K,
                                                  tdt))
        assert plain_calls["fused_topk_encode_blocked"] == before + 1
        assert d * h * 2 > cuda_sae.FUSED_W_BYTES
    for got in got_all:
        assert got.dtype == tdt and got.shape == (rows, h)
        assert torch.equal(got > 0, plain > 0)
        got = got.float().numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        assert ((got > 0).sum(axis=1) == K).all()
        if out == "bf16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the select model past the CTA's registers
# ---------------------------------------------------------------------------

WIDE = [49152, 81920, 262144]


@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("h", WIDE)
def test_select_mask_bit_identical_to_jax(h, k):
    rng = np.random.default_rng(h + k)
    pre = (rng.standard_normal((4, h)) * rng.uniform(0.05, 3.0, (4, 1))).astype(np.float32)
    assert _build.select_form(h) == "cluster"
    _check_select(pre, k)


@pytest.mark.parametrize("h", WIDE)
@pytest.mark.parametrize("case", EDGES)
def test_select_edge_cases_bit_identical_to_jax(case, h):
    pre, k = _edge_rows(case, h)
    _check_select(pre, k)


@pytest.mark.parametrize("h", [49152, 262144])
def test_topk_mask_dense_past_the_cta_row_exact(h):
    """Kernel C's plain version past H = 40960, counted as its wide form."""
    rng = np.random.default_rng(h + 1)
    pre = rng.standard_normal((4, h)).astype(np.float32)
    pre[:2] = np.round(pre[:2] * 2) / 2  # exact ties at the threshold
    before = plain_calls["topk_mask_wide"]
    got = topk_mask_dense(torch.from_numpy(pre), K).numpy()
    assert plain_calls["topk_mask_wide"] == before + 1
    want = np.asarray(jtopk.topk_mask_dense(jnp.asarray(pre), K))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# the chunk rule
# ---------------------------------------------------------------------------


def test_chunk_rule_every_width_to_the_blocked_limit():
    """At every H (a multiple of 32) up to 2^20: the encode's chunk holds
    a row or more, 128 or a multiple of it wherever the budget holds 128
    rows, and its f32 pre never passes ``PRE_BUDGET`` (the workspace: that
    plus the chunk's centred rows)."""
    tile = _build.GEMM_TILE_ROWS
    for h in range(32, _build.MAX_BLOCKED_ROW + 1, 32):
        rows = _build.topk_encode_chunk_rows(h)
        fits = _build.PRE_BUDGET // (4 * h)
        assert rows >= 1 and rows * h * 4 <= _build.PRE_BUDGET, h
        if fits >= tile:
            assert rows % tile == 0 and rows + tile > fits, h
        else:
            assert rows == fits, h


@pytest.mark.parametrize("h,rows", [(3072, 27264), (20480, 4096), (40960, 2048), (49152, 1664),
                                    (81920, 1024), (655360, 128), (655392, 127), (1 << 20, 80)])
def test_chunk_rule_values(h, rows):
    assert _build.topk_encode_chunk_rows(h) == rows


# ---------------------------------------------------------------------------
# the AMP trainer past H = 40960
# ---------------------------------------------------------------------------

TD, TH, TB, TSTEPS = 128, 49152, 16, 3  # width, features, batch, steps an epoch; 2 epochs


def _sae_params(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(TD)
    w_dec = rng.standard_normal((TH, TD))
    return {
        "w_enc": rng.uniform(-bound, bound, (TD, TH)).astype(np.float32),
        "b_enc": rng.uniform(-bound, bound, TH).astype(np.float32),
        "w_dec": (0.1 * w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True)).astype(np.float32),
        "b_dec": (rng.standard_normal(TD) * 0.1).astype(np.float32),
        "b_pre": (rng.standard_normal(TD) * 0.1).astype(np.float32),
    }


def test_amp_trainer_past_the_cta_row_matches_jax(monkeypatch, tmp_path):
    """The port composes the loss around kernel B (its plain version) on
    the sliced epoch; the JAX package, with its Pallas encode on (interpret
    mode) and its fused loss off (it fuses these widths on a TPU, the port
    past H = 40960 does not), composes it around its non-blocked encode."""
    monkeypatch.setattr(ps, "supported", lambda *a: True)
    monkeypatch.setattr(ps, "fused_loss_supported", lambda *a: False)
    assert not cuda_sae.fused_loss_supported(TD, TH) and not cuda_sae.uses_blocked(TD, TH)
    p = _sae_params(21)
    data = np.random.default_rng(22).standard_normal((TSTEPS * TB, TD)).astype(np.float32)
    perms = [np.random.default_rng(23 + e).permutation(len(data)) for e in range(2)]
    kw = dict(batch_size=TB, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=True, seed=3)
    jt = JSAETrainer(jsae.TopKSAE(TD, TH, K, params={n: jnp.asarray(v) for n, v in p.items()}),
                     JTrainingConfig(**kw), run_dir=tmp_path / "j")
    tt = SAETrainer(tsae.TopKSAE(TD, TH, K, params=params_from_jax(p), device="cpu"),
                    TrainingConfig(**kw), run_dir=tmp_path / "t")
    assert not jt._use_indexed_epoch(data) and not tt._use_indexed_epoch()
    for t in (jt, tt):
        t.setup_scheduler(2 * TSTEPS)
    with pltpu.force_tpu_interpret_mode():
        jl = [m.loss for perm in perms for m in jt.train_epoch_fused(jnp.asarray(data), perm=perm)]
    before = dict(plain_calls)
    tl = [m.loss for perm in perms for m in tt.train_epoch_fused(torch.from_numpy(data), perm=perm)]
    moved = {n: v - before.get(n, 0) for n, v in plain_calls.items() if v != before.get(n, 0)}
    assert moved == {"fused_topk_encode": 2 * TSTEPS}
    assert len(tl) == len(jl) == 2 * TSTEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for n in p:
        np.testing.assert_allclose(tt.model.params[n].detach().numpy(),
                                   np.asarray(jt.model.params[n]), atol=2e-4, err_msg=n)
    np.testing.assert_array_equal(tt.model.feature_last_activated.numpy(),
                                  np.asarray(jt.model.state.feature_last_activated))
