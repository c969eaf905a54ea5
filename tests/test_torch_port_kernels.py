"""Plain versions of kernels A and B against the JAX package's Pallas
kernels, run in interpret mode as ``tests/test_pallas_interpret.py`` runs
them.

Tolerances: the loss at rtol 1e-5 (the bar of test_pallas_interpret.py),
l0 and the any-active vector exactly, the bf16 latent within bf16
rounding (atol 1e-2 * max|hidden|), gradients at rtol 1e-2 (bf16
products summed in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_sae_tpu.ops import pallas_sae as ps
from whisper_sae_tpu_torch.ops import cuda_sae

B, D, H, K = 64, 128, 512, 8
BLOCK = 8
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")


def _params(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "w_enc": (rng.standard_normal((D, H)) * 0.2).astype(np.float32),
        "b_enc": (rng.standard_normal(H) * 0.05).astype(np.float32),
        "b_pre": (rng.standard_normal(D) * 0.05).astype(np.float32),
        "w_dec": (rng.standard_normal((H, D)) * 0.2).astype(np.float32),
        "b_dec": (rng.standard_normal(D) * 0.05).astype(np.float32),
    }


def _rows(seed: int, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _torch_params(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


def _close_grad(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-5 * float(np.max(np.abs(want))))


# ---------------------------------------------------------------------------
# kernel B: fused top-k encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_encode_matches_pallas_interpret(out):
    p, x = _params(1), _rows(2)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want = ps.fused_topk_encode(
            jnp.asarray(x), jnp.asarray(p["w_enc"]), jnp.asarray(p["b_enc"]),
            jnp.asarray(p["b_pre"]), K, BLOCK, jdt,
        )
    want = np.asarray(want.astype(jnp.float32))
    got = cuda_sae.fused_topk_encode(
        torch.from_numpy(x), torch.from_numpy(p["w_enc"]), torch.from_numpy(p["b_enc"]),
        torch.from_numpy(p["b_pre"]), K, tdt,
    )
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)  # identical selection
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_encode_grads_match_pallas_interpret():
    p, x = _params(3), _rows(4)
    g = np.random.default_rng(5).standard_normal((B, H)).astype(np.float32)

    def f(w_enc, b_enc, b_pre):
        with pltpu.force_tpu_interpret_mode():
            return ps.fused_topk_encode(jnp.asarray(x), w_enc, b_enc, b_pre, K, BLOCK, jnp.float32)

    _, vjp = jax.vjp(f, *(jnp.asarray(p[n]) for n in ("w_enc", "b_enc", "b_pre")))
    want = vjp(jnp.asarray(g))
    tp = _torch_params(p)
    cuda_sae.fused_topk_encode(
        torch.from_numpy(x), tp["w_enc"], tp["b_enc"], tp["b_pre"], K, torch.float32
    ).backward(torch.from_numpy(g))
    for name, w in zip(("w_enc", "b_enc", "b_pre"), want):
        _close_grad(tp[name].grad.numpy(), w)


# ---------------------------------------------------------------------------
# kernel A: fused loss, sliced and at a row offset
# ---------------------------------------------------------------------------


def _jax_loss_and_grads(loss_fn, p):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (loss, l0, active), vjp = jax.vjp(loss_fn, jp)
    (grads,) = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32),
                    np.zeros(H, jax.dtypes.float0)))
    return float(loss), float(l0), np.asarray(active), {k: np.asarray(v) for k, v in grads.items()}


def _check(got, want):
    tl, tl0, tact, tp = got
    jl, jl0, jact, jg = want
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    assert float(tl0) == jl0
    np.testing.assert_array_equal(tact.numpy(), jact)
    for name in NAMES:
        _close_grad(tp[name].grad.numpy(), jg[name])


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_fused_loss_matches_pallas_interpret(x_dtype):
    p, x = _params(6), _rows(7)
    if x_dtype == "bf16":  # rows staged in bf16 (a bf16 cache)
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if x_dtype == "bf16" else torch.float32)

    def loss_fn(q):
        with pltpu.force_tpu_interpret_mode():
            return ps.fused_sae_loss(xj, q["w_enc"], q["b_enc"], q["b_pre"], q["w_dec"],
                                     q["b_dec"], K, BLOCK)

    want = _jax_loss_and_grads(loss_fn, p)
    tp = _torch_params(p)
    loss, l0, active = cuda_sae.fused_sae_loss(
        xt, tp["w_enc"], tp["b_enc"], tp["b_pre"], tp["w_dec"], tp["b_dec"], K
    )
    loss.backward()
    _check((loss.detach(), l0, active, tp), want)


@pytest.mark.parametrize("step", [0, 2])
def test_indexed_fused_loss_matches_pallas_interpret(step):
    p = _params(8)
    buf = _rows(9, 3 * B)

    def loss_fn(q):
        with pltpu.force_tpu_interpret_mode():
            return ps.fused_sae_loss_indexed(
                jnp.asarray(buf), jnp.int32(step), q["w_enc"], q["b_enc"], q["b_pre"],
                q["w_dec"], q["b_dec"], K, BLOCK, B,
            )

    want = _jax_loss_and_grads(loss_fn, p)
    tp = _torch_params(p)
    loss, l0, active = cuda_sae.fused_sae_loss_indexed(
        torch.from_numpy(buf), step, tp["w_enc"], tp["b_enc"], tp["b_pre"], tp["w_dec"],
        tp["b_dec"], K, B,
    )
    loss.backward()
    _check((loss.detach(), l0, active, tp), want)


def test_fused_loss_input_grad_matches_pallas_interpret():
    p, x = _params(10), _rows(11)

    def f(xx):
        with pltpu.force_tpu_interpret_mode():
            return ps.fused_sae_loss(xx, *(jnp.asarray(p[n]) for n in NAMES), K, BLOCK)[0]

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    cuda_sae.fused_sae_loss(xt, *(tp[n] for n in NAMES), K)[0].backward()
    _close_grad(xt.grad.numpy(), want)


def test_indexed_window_equals_slice():
    p = {k: torch.from_numpy(v) for k, v in _params(12).items()}
    buf = torch.from_numpy(_rows(13, 2 * B + 16))
    a = cuda_sae.fused_sae_loss_indexed(buf, 1, *(p[n] for n in NAMES), K, B)
    b = cuda_sae.fused_sae_loss(buf[B:2 * B], *(p[n] for n in NAMES), K)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_cpu_dispatch_counts_no_launch():
    p = {k: torch.from_numpy(v) for k, v in _params(14).items()}
    x = torch.from_numpy(_rows(15))
    before = (cuda_sae.fused_sae_loss.launches, cuda_sae.fused_sae_loss_indexed.launches,
              cuda_sae.fused_topk_encode.launches)
    cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    cuda_sae.fused_sae_loss_indexed(x, 0, *(p[n] for n in NAMES), K, B)
    cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    assert before == (cuda_sae.fused_sae_loss.launches, cuda_sae.fused_sae_loss_indexed.launches,
                      cuda_sae.fused_topk_encode.launches)
