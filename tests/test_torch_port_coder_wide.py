"""The coder kernel at a row wider than a warp's registers (H = 3200 >
3072) against the JAX package's Pallas coder kernel, run in interpret mode
as ``tests/test_torch_port_coder_ops.py`` runs it, on the CPU.

On the card the TopK modes take the wide route there (one CTA a row,
``wst_coder_wide_fwd``), the ReLU modes their one route; on the CPU each
entry runs its plain version.  D = dout = 128, H = 3200, k = 32; the
crosscoders as L = 2 layers of 64 (S = 3200).

- All five modes through their ``autograd.Function``, sliced and at a row
  offset into a 3-batch buffer (the indexed entry), f32 and bf16 rows:
  the loss (and recon, sparsity) at rtol 1e-5, l0 and the any-active
  vector exactly, the residual and the bf16 latent within bf16 rounding
  (atol 1e-2 * max), every gradient at rtol 1e-2 (the bars of
  ``test_torch_port_coder_ops.py``; the gradients' floor atol 1e-2 * max,
  as ``test_torch_port_large.py`` has it at its wide geometries: over
  3200 features a bf16 step of dpre rounded the other way moves a few
  near-cancelling elements of dW_enc past 1%); the ReLU modes'
  per-feature sums within bf16 rounding.
- The wide route's order written out (``coder_topk_route_plain`` with
  ``per_row``: 32-column tiles, one partial a row) against
  ``coder_forward_plain`` (bf16 rows, latent, l0 and active bit-equal,
  the residual within f32 sum order, sum(resid^2) at rtol 1e-5) and
  against the JAX kernel at the bars above.
- The gate against the JAX package's 48 MiB rule.
- The AMP windowed trainer against the JAX trainer's windowed Pallas epoch
  for the Skip transcoder and the TopK crosscoder: the loss trajectory at
  rtol 1e-3 (``test_torch_port_wide_loss.py``'s bar).
- ``crosscoder_apply`` under AMP encodes the flattened view through the
  top-k encode, as the JAX package does: the latent within bf16 rounding
  and the loss at rtol 1e-5 against JAX's non-blocked Pallas encode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models import crosscoder as jxc
from whisper_sae_tpu.models import transcoder as jtc
from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu.training import coder_trainers as jct
from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models import crosscoder as txc
from whisper_sae_tpu_torch.models import transcoder as ttc
from whisper_sae_tpu_torch.ops import _build
from whisper_sae_tpu_torch.ops import cuda_coder as cc
from whisper_sae_tpu_torch.ops.topk import plain_calls as topk_plain_calls
from whisper_sae_tpu_torch.training import coder_trainers as tct
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

B, D, H, K = 32, 128, 3200, 32
L = 2
BLOCK = 8
SW = 0.01
TILE = 32  # the wide route's decode tile: 32 output columns
MODES = ("skip_transcoder", "topk_transcoder", "relu_sae", "topk_crosscoder", "relu_crosscoder")
TOPK_MODES = ("skip_transcoder", "topk_transcoder", "topk_crosscoder")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(mode: str, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    p = {
        "w_enc": rng.standard_normal((D, H)) / np.sqrt(D),
        "b_enc": rng.standard_normal(H) * 0.05,
        "w_dec": rng.standard_normal((H, D)) * 0.1,
        "b_dec": rng.standard_normal(D) * 0.05,
    }
    if mode == "skip_transcoder":
        p["w_skip"] = rng.standard_normal((D, D)) * 0.1
        p["b_skip"] = rng.standard_normal(D) * 0.05
    if mode == "relu_crosscoder":
        p["norms"] = np.linalg.norm(p["w_dec"], axis=1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _jax_call(mode, q, x, y, step=None):
    """The JAX entry of ``mode`` in interpret mode; ``step`` selects the
    indexed form."""
    zero = jnp.zeros((), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        if mode in TOPK_MODES:
            skip = mode == "skip_transcoder"
            yy = x if mode == "topk_crosscoder" else y
            args = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"], q.get("w_skip", zero),
                    q.get("b_skip", zero), K)
            if step is None:
                return ps.fused_transcoder_loss(x, yy, *args, BLOCK, skip,
                                                mode == "topk_crosscoder")
            return ps.fused_transcoder_loss_indexed(x, yy, jnp.int32(step), *args, BLOCK, B,
                                                    skip, mode == "topk_crosscoder")
        base = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"])
        if mode == "relu_sae":
            if step is None:
                return ps.fused_relu_sae_loss(x, *base, SW, BLOCK)
            return ps.fused_relu_sae_loss_indexed(x, jnp.int32(step), *base, SW, BLOCK, B)
        if step is None:
            return ps.fused_relu_crosscoder_loss(x, *base, q["norms"], SW, L, BLOCK)
        return ps.fused_relu_crosscoder_loss_indexed(x, jnp.int32(step), *base, q["norms"], SW,
                                                     L, BLOCK, B)


def _torch_call(mode, q, x, y, step=None):
    if mode in TOPK_MODES:
        skip = mode == "skip_transcoder"
        args = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"], q.get("w_skip"), q.get("b_skip"),
                K)
        if step is None:
            return cc.fused_transcoder_loss(x, y, *args, skip, mode == "topk_crosscoder")
        return cc.fused_transcoder_loss_indexed(x, y, step, *args, B, skip,
                                                mode == "topk_crosscoder")
    base = (q["w_enc"], q["b_enc"], q["w_dec"], q["b_dec"])
    if mode == "relu_sae":
        if step is None:
            return cc.fused_relu_sae_loss(x, *base, SW)
        return cc.fused_relu_sae_loss_indexed(x, step, *base, SW, B)
    if step is None:
        return cc.fused_relu_crosscoder_loss(x, *base, q["norms"], SW, L)
    return cc.fused_relu_crosscoder_loss_indexed(x, step, *base, q["norms"], SW, L, B)


def _cotangents(mode, outs):
    """1 for the loss, 0.3 / 0.7 for the ReLU families' recon / sparsity,
    zero elsewhere."""
    cots = []
    for i, o in enumerate(outs):
        if o.dtype == jnp.bool_:
            cots.append(np.zeros(o.shape, jax.dtypes.float0))
        elif i == 0:
            cots.append(jnp.ones((), jnp.float32))
        elif mode.startswith("relu") and i in (1, 2):
            cots.append(jnp.asarray((0.3, 0.7)[i - 1], jnp.float32))
        else:
            cots.append(jnp.zeros(o.shape, o.dtype))
    return tuple(cots)


def _within_bf16(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def _ops(p: dict[str, torch.Tensor], mode: str) -> cc.CoderOperands:
    skip = mode == "skip_transcoder"
    b_out = p["b_dec"] + p["b_skip"] if skip else p["b_dec"]
    return cc.operands(p["w_enc"], p["b_enc"], p["w_dec"], b_out, p.get("w_skip"),
                       topk=mode in TOPK_MODES)


CASES = {"sliced": (B, 0, None), "indexed": (3 * B, 2 * B, 2)}  # buffer rows, offset, step


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_pallas_interpret(mode, case, x_dtype):
    n, off, step = CASES[case]
    p = _params(mode, 1 + MODES.index(mode))
    xn, yn = _rows(10, n), _rows(11, n)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if x_dtype == "bf16" else (jnp.float32, torch.float32)
    xj, yj = jnp.asarray(xn).astype(jdt), jnp.asarray(yn).astype(jdt)
    outs, vjp = jax.vjp(lambda q: _jax_call(mode, q, xj, yj, step),
                        {k: jnp.asarray(v) for k, v in p.items()})
    (jg,) = vjp(_cotangents(mode, outs))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt, yt = torch.from_numpy(xn).to(tdt), torch.from_numpy(yn).to(tdt)
    before = cc.plain_calls[mode]
    touts = _torch_call(mode, tp, xt, yt, step)
    assert cc.plain_calls[mode] == before + 1
    roots, grads = [touts[0]], [torch.ones(())]
    if mode.startswith("relu"):
        roots += [touts[1], touts[2]]
        grads += [torch.tensor(0.3), torch.tensor(0.7)]
    torch.autograd.backward(roots, grads)

    np.testing.assert_allclose(float(touts[0]), float(outs[0]), rtol=1e-5)
    if mode.startswith("relu"):
        for i in (1, 2):  # recon, sparsity
            np.testing.assert_allclose(float(touts[i]), float(outs[i]), rtol=1e-5)
    l0_i = 3 if mode.startswith("relu") else 1
    assert float(touts[l0_i]) == float(outs[l0_i])
    np.testing.assert_array_equal(touts[l0_i + 1].numpy(), np.asarray(outs[l0_i + 1]))
    if step is None and not mode.startswith("relu"):  # resid, bf16 latent
        _within_bf16(touts[3], outs[3])
        _within_bf16(touts[4], outs[4].astype(jnp.float32))
    for name in tp:
        want = np.asarray(jg[name], np.float32)
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * float(np.max(np.abs(want))), err_msg=name)

    if mode in TOPK_MODES:  # the wide route's order on the same rows
        t = {k: torch.from_numpy(v) for k, v in p.items()}
        ops = _ops(t, mode)
        ybuf = None if mode == "topk_crosscoder" else yt
        got = cc.coder_topk_route_plain(xt, ybuf, off, B, ops, K, TILE, per_row=True)
        win = slice(off, off + B)
        plain = cc.coder_forward_plain(xt[win], None if ybuf is None else ybuf[win], ops, K)
        assert torch.equal(got.xc, plain.xc) and torch.equal(got.hid, plain.hid)
        assert int(got.l0) == int(plain.l0) and torch.equal(got.active, plain.active)
        torch.testing.assert_close(got.resid, plain.resid, rtol=0,
                                   atol=1e-5 * float(plain.resid.abs().max()))
        torch.testing.assert_close(got.sq, plain.sq, rtol=1e-5, atol=0)
        np.testing.assert_allclose(float(got.sq) / (B * D), float(outs[0]), rtol=1e-5)
        assert float(np.float32(int(got.l0)) / np.float32(B)) == float(outs[1])
        np.testing.assert_array_equal(got.active.numpy(), np.asarray(outs[2]))
        if step is None:
            _within_bf16(got.resid, outs[3])
            _within_bf16(got.hid, outs[4].astype(jnp.float32))


@pytest.mark.parametrize("mode", ["relu_sae", "relu_crosscoder"])
def test_hidden_sums_match_pallas_interpret(mode):
    """The per-feature hidden sums and the L1 sum at H = 3200 against the
    JAX kernel's accumulators."""
    p, x = _params(mode, 8), _rows(9, B)
    zero = jnp.zeros((), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        out = ps._fused_coder_impl(jnp.asarray(x), jnp.asarray(x), jnp.asarray(p["w_enc"]),
                                   jnp.asarray(p["b_enc"]), jnp.asarray(p["w_dec"]),
                                   jnp.asarray(p["b_dec"]), zero, zero, None, BLOCK, False, True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = cc.coder_forward_plain(torch.from_numpy(x), None, _ops(t, mode), None)
    np.testing.assert_allclose(float(got.l1), float(out[5]), rtol=1e-5)
    _within_bf16(got.hsum, out[6])
    _within_bf16(got.resid, out[3])


def test_wide_route_partials_change_no_bits():
    """The wide route's 32-column tiles split the output columns and
    nothing else: one pass, tiles of 32 and passes of 96 give the same
    residual; one partial a row sums the same squares as one a CTA."""
    t = {k: torch.from_numpy(v) for k, v in _params("topk_crosscoder", 12).items()}
    ops = _ops(t, "topk_crosscoder")
    x = torch.from_numpy(_rows(13, 50))
    outs = [cc.coder_topk_route_plain(x, None, 3, 45, ops, K, cols, per_row=True)
            for cols in (D, TILE, 96)]
    for o in outs[1:]:
        assert torch.equal(o.resid, outs[0].resid) and torch.equal(o.sq, outs[0].sq)
    cta = cc.coder_topk_route_plain(x, None, 3, 45, ops, K, TILE)
    assert torch.equal(cta.resid, outs[0].resid)
    torch.testing.assert_close(cta.sq, outs[0].sq, rtol=1e-6, atol=0)


def test_dispatch_counts_no_launch_on_the_cpu():
    """On the CPU every mode runs its plain version; no launch, wide or
    not, is counted.  The route is picked by width and mode alone."""
    before = [(e.launches, e.wide_launches) for e in cc.ENTRIES]
    for mode in MODES:
        p = {k: torch.from_numpy(v) for k, v in _params(mode, 14).items()}
        x, y = torch.from_numpy(_rows(15, 2 * B)), torch.from_numpy(_rows(16, 2 * B))
        _torch_call(mode, p, x[:B], y[:B])
        _torch_call(mode, p, x, y, 1)
    assert [(e.launches, e.wide_launches) for e in cc.ENTRIES] == before
    assert cc.uses_wide(H, K) and not cc.uses_wide(H, None)
    assert not cc.uses_wide(_build.MAX_ROW, K) and cc.uses_wide(_build.MAX_ROW + 32, K)


# ---------------------------------------------------------------------------
# the gate: the JAX package's 48 MiB rule, with the skip path counted
# ---------------------------------------------------------------------------

# (D, dout, H, fused without skip, fused with skip)
GATE_TABLE = {
    "tiny_8x": (384, 384, 3072, True, True), "tiny_64x": (384, 384, 24576, True, True),
    "base_8x": (512, 512, 4096, True, True), "small_8x": (768, 768, 6144, True, True),
    "small_16x": (768, 768, 12288, True, True), "medium_8x": (1024, 1024, 8192, True, True),
    "medium_12x": (1024, 1024, 12288, True, False), "large_8x": (1280, 1280, 10240, False, False),
    "tiny_128x": (384, 384, 49152, False, False),
    "crosscoder_768_s6144": (768, 768, 6144, True, True),
    "crosscoder_1536_s6144": (1536, 1536, 6144, True, True),
    "crosscoder_1536_s12288": (1536, 1536, 12288, False, False),
}


@pytest.mark.parametrize("name", GATE_TABLE)
def test_gate_table(name, monkeypatch):
    d, dout, h, plain, skip = GATE_TABLE[name]
    assert cc.coder_supported(d, dout, h) is plain
    assert cc.coder_supported(d, dout, h, with_skip=True) is skip
    # the JAX gate on a TPU-sized batch, its backend check lifted
    monkeypatch.setattr(ps, "supported", lambda *a: True)
    for with_skip, want in ((False, plain), (True, skip)):
        assert ps.fused_coder_supported((4096, d), dout, h, with_skip=with_skip) is want
    assert not cc.coder_supported(d + 16, dout, h) and not cc.coder_supported(d, dout, h + 16)


def test_gate_caps_the_row_width():
    """A narrow geometry within the budget but past the CTA select's row."""
    assert cc.coder_supported(32, 32, _build.MAX_WIDE_ROW)
    assert not cc.coder_supported(32, 32, _build.MAX_WIDE_ROW + 32)


# ---------------------------------------------------------------------------
# the AMP windowed trainer against the JAX trainer's windowed Pallas epoch
# ---------------------------------------------------------------------------

TN = 3 * B + 16  # 3 windowed steps and a 16-row remainder step an epoch


def _trainer_params(family: str, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    if family == "topk_crosscoder":
        w_dec = rng.standard_normal((H, L, D // L))
        w_dec = 0.1 * w_dec / np.linalg.norm(w_dec.reshape(H, -1), axis=1)[:, None, None]
        p = {"w_enc": np.transpose(w_dec, (1, 2, 0)) * 3, "b_enc": rng.uniform(-1, 1, H) * 0.01,
             "w_dec": w_dec, "b_dec": rng.uniform(-1, 1, (L, D // L)) * 0.01}
    else:
        w_dec = rng.standard_normal((H, D))
        p = {"w_enc": rng.uniform(-1, 1, (D, H)) / np.sqrt(D),
             "b_enc": rng.uniform(-1, 1, H) / np.sqrt(D),
             "w_dec": w_dec / np.linalg.norm(w_dec, axis=1, keepdims=True),
             "b_dec": rng.uniform(-1, 1, D) * 0.1,
             "w_skip": rng.uniform(-1, 1, (D, D)) * 0.3 / np.sqrt(D),
             "b_skip": rng.uniform(-1, 1, D) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("family", ["skip_transcoder", "topk_crosscoder"])
def test_windowed_amp_trainer_matches_jax(family, tmp_path, monkeypatch):
    params = _trainer_params(family, 20)
    rng = np.random.default_rng(21)
    if family == "topk_crosscoder":
        data = rng.standard_normal((TN, L, D // L)).astype(np.float32)
        jdata, tdata = jnp.asarray(data), torch.from_numpy(data)
    else:
        x = rng.standard_normal((TN, D)).astype(np.float32)
        y = (np.tanh(x @ rng.standard_normal((D, D)) / np.sqrt(D))
             + 0.1 * rng.standard_normal((TN, D))).astype(np.float32)
        jdata, tdata = (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x), torch.from_numpy(y))
    perms = [rng.permutation(TN) for _ in range(2)]
    kw = dict(batch_size=B, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=True, seed=3)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, params_from_jax(params)
    if family == "topk_crosscoder":
        jm = jxc.create_crosscoder(D // L, L, H, k=K, use_topk=True, params=jp)
        tm = txc.create_crosscoder(D // L, L, H, k=K, use_topk=True, params=tp, device="cpu")
        jt = jct.CrosscoderTrainer(jm, JTrainingConfig(**kw), run_dir=tmp_path / "j")
        tt = tct.CrosscoderTrainer(tm, TrainingConfig(**kw), run_dir=tmp_path / "t")
    else:
        jm = jtc.create_transcoder(D, D, H, k=K, use_skip=True, params=jp)
        tm = ttc.create_transcoder(D, D, H, k=K, use_skip=True, params=tp, device="cpu")
        jt = jct.TranscoderTrainer(jm, JTrainingConfig(**kw), run_dir=tmp_path / "j")
        tt = tct.TranscoderTrainer(tm, TrainingConfig(**kw), run_dir=tmp_path / "t")
    # the JAX trainers take their windowed Pallas coder kernels, in interpret mode
    monkeypatch.setattr(ps, "fused_coder_supported", lambda *a, **k: True)
    monkeypatch.setenv("WST_INDEXED_EPOCH", "1")
    assert tt._use_indexed_epoch() and jt._use_indexed_epoch(jdata)
    for t in (jt, tt):
        t.setup_scheduler(8)
    with pltpu.force_tpu_interpret_mode():
        jl = [m.loss for perm in perms for m in jt.train_epoch_fused(jdata, perm=perm)]
    before = dict(cc.plain_calls)
    tl = [m.loss for perm in perms for m in tt.train_epoch_fused(tdata, perm=perm)]
    moved = {k: v - before.get(k, 0) for k, v in cc.plain_calls.items() if v != before.get(k, 0)}
    assert moved == {family: 8}  # 6 windowed steps and 2 remainder steps, all on the kernel
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


# ---------------------------------------------------------------------------
# crosscoder_apply under AMP: the flattened encode through the top-k encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,route", [(256, "fused_topk_encode"), (H, "fused_topk_encode")])
def test_crosscoder_apply_encodes_like_jax(s, route, monkeypatch):
    """S = 256 and 3200: kernel B's route, as the JAX side takes its
    non-blocked Pallas encode (its backend check lifted, in interpret
    mode): bf16 W_enc within 48 MiB."""
    rng = np.random.default_rng(30 + s)
    w_dec = rng.standard_normal((s, L, D // L))
    w_dec = 0.1 * w_dec / np.linalg.norm(w_dec.reshape(s, -1), axis=1)[:, None, None]
    params = {"w_enc": (np.transpose(w_dec, (1, 2, 0)) * 3).astype(np.float32),
              "b_enc": (rng.uniform(-1, 1, s) * 0.01).astype(np.float32),
              "w_dec": w_dec.astype(np.float32),
              "b_dec": (rng.uniform(-1, 1, (L, D // L)) * 0.01).astype(np.float32)}
    acts = rng.standard_normal((L, B, D // L)).astype(np.float32)
    monkeypatch.setattr(ps, "supported", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        jrecon, jhid, jloss, jrec, _, jl0 = jxc.crosscoder_apply(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(acts), k=K,
            compute_dtype=jnp.bfloat16)
    before = dict(topk_plain_calls)
    recon, hid, loss, rec, sparsity, l0 = txc.crosscoder_apply(
        params_from_jax(params), torch.from_numpy(acts), k=K, compute_dtype=torch.bfloat16)
    moved = {k: v - before.get(k, 0) for k, v in topk_plain_calls.items()
             if v != before.get(k, 0)}
    assert moved == {route: 1}
    assert hid.dtype == torch.bfloat16 and jhid.dtype == jnp.bfloat16
    _within_bf16(hid, jhid.astype(jnp.float32))
    np.testing.assert_array_equal(hid.float().numpy() > 0, np.asarray(jhid.astype(jnp.float32)) > 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(rec), float(jrec), rtol=1e-5)
    assert float(l0) == float(jl0) and float(sparsity) == 0.0
    _within_bf16(recon, jrecon)
