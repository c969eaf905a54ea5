"""The TopK SAE step's backward over the selected latents, on the CPU.

``ops.cuda_sae.sae_topk_backward_plain`` (the plain version of
``csrc/sae_backward.cu``: compaction, per-entry dots, feature-major sums,
both routes' rounding points) is held against the dense ``mm_f32``
products each route ran before (``_dense_topk_backward``), leaf by leaf.
On inputs of small multiples of powers of two every f32 sum is exact in
any order, so the two must agree bit for bit whatever the shapes and the
pattern of the latent; on the routes' own latents they agree in f32 sum
order (max |gap| <= 1e-5 max |g|) where no bf16 rounding follows the
sums.  The CPU routes keep the dense products; the composed route's
autograd function, which bf16 ``topk_sae_loss`` takes wherever kernel A
does not hold, equals autograd through ``topk_sae_apply``.
"""

from __future__ import annotations

import pytest
import torch

from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.ops import cuda_sae
from whisper_sae_tpu_torch.ops.topk import plain_calls

K = 8
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")
# (rows, D, H): not multiples of the kernel's 32-row mask words, 128-column
# warps or 8-feature tiles; whisper-tiny's widths; four warps a feature
SHAPES = [(200, 96, 352), (37, 160, 64), (300, 384, 3072), (65, 1312, 128)]
ROUTES = pytest.mark.parametrize("composed", [False, True], ids=["kernel_a", "composed"])


def _latent(rows, h, k, seed):
    """A bf16 latent of small multiples of 1/4 with k features a row, and an
    all-zero row, a row with k/2 entries, one with k + 3 (as a tie at the
    k-th value gives), a feature every other row selects and features no
    row selects."""
    g = torch.Generator().manual_seed(seed)
    keys = torch.rand(rows, h, generator=g)
    keys[:, h - 16:] = -1.0
    top = keys.topk(k + 3, dim=1).indices
    sel = torch.zeros(rows, h, dtype=torch.bool)
    sel.scatter_(1, top[:, :k], True)
    sel[1, top[1, k // 2:k]] = False
    sel[2, top[2]] = True
    sel[:, 3] = True
    sel[0] = False
    vals = torch.randint(1, 5, (rows, h), generator=g).float() * 0.25
    return torch.where(sel, vals, 0.0).bfloat16()


def _exact_inputs(rows, d, h, seed, composed):
    """(hid, d_recon, xc, W_dec) of multiples of 1/8 in [-1/4, 1/4] (the
    latent's of 1/4 in [1/4, 1]): at these sizes every product is exact
    and every sum stays under 2^24 of its smallest step, in any order."""
    g = torch.Generator().manual_seed(seed + 1)

    def ints(*shape):
        return torch.randint(-2, 3, shape, generator=g).float() * 0.125

    d_recon = ints(rows, d)
    return (_latent(rows, h, K, seed), d_recon if composed else d_recon.bfloat16(),
            ints(rows, d).bfloat16(), ints(h, d).bfloat16())


def _params(seed, d, h):
    g = torch.Generator().manual_seed(seed)
    return {"w_enc": torch.randn(d, h, generator=g) * 0.05,
            "b_enc": torch.randn(h, generator=g) * 0.05,
            "b_pre": torch.randn(d, generator=g) * 0.05,
            "w_dec": torch.randn(h, d, generator=g) * 0.05,
            "b_dec": torch.randn(d, generator=g) * 0.05}


def _route_inputs(rows, d, h, seed, composed, params=None):
    """The route's own latent, d_recon, xc and bf16 W_dec from its CPU
    forward on gaussian rows."""
    p = params or _params(seed, d, h)
    x = torch.randn(rows, d, generator=torch.Generator().manual_seed(seed + 1))
    we_t, wd_bf = cuda_sae._bf16_t(p["w_enc"]), p["w_dec"].bfloat16()
    if composed:
        hid = cuda_sae.topk_encode_plain(x, we_t, p["b_enc"], p["b_pre"], K, torch.bfloat16)
        xc = (x - p["b_pre"]).bfloat16()
        resid = cuda_sae.mm_f32(hid, wd_bf) + p["b_dec"] + p["b_pre"] - x
        return hid, resid * (2.0 / resid.numel()), xc, wd_bf
    _, _, _, hid, resid, xc = cuda_sae.fused_sae_loss_plain(
        x, we_t, p["b_enc"], p["b_pre"], wd_bf, p["b_dec"] + p["b_pre"], K)
    return hid, (resid * (2.0 / resid.numel())).bfloat16(), xc, wd_bf


def _check_leaves(got, want, composed):
    """Leaf by leaf in f32 sum order: max |gap| <= 1e-5 max |g| where no
    bf16 rounding follows the sums (kernel A's dW_dec and db_enc).  Where
    dpre is rounded to bf16 before the sum (dW_enc; the composed route's
    db_enc), a dot whose sums land on the other side of a bf16 rounding
    boundary moves its entries' terms by one bf16 step: max |gap| <= 2^-8
    max |g| and the mean |gap| <= 1e-5 max |g|; the composed route's dW_dec,
    rounded after its sum, each element within one bf16 step of itself."""
    for name, g, w in zip(("dw_enc", "db_enc", "dw_dec"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32, name
        top = float(w.abs().max())
        gap = (g - w).abs()
        if name == "dw_dec" and composed:
            assert bool((gap <= 2.0 ** -7 * w.abs() + 1e-5 * top).all()), name
        elif name == "dw_enc" or composed:
            assert float(gap.max()) <= 2.0 ** -8 * top, name
            assert float(gap.mean()) <= 1e-5 * top, name
        else:
            assert float(gap.max()) <= 1e-5 * top, name


@ROUTES
@pytest.mark.parametrize("rows,d,h", SHAPES)
def test_plain_equals_dense_on_exact_inputs(rows, d, h, composed):
    args = _exact_inputs(rows, d, h, rows + d, composed)
    got = cuda_sae.sae_topk_backward_plain(*args, composed)
    want = cuda_sae._dense_topk_backward(*args, composed)
    for name, g, w in zip(("dw_enc", "db_enc", "dw_dec"), got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), name
        assert torch.equal(g, w), name


@ROUTES
@pytest.mark.parametrize("rows,d,h", SHAPES[:3])
def test_plain_matches_dense_on_the_routes_inputs(rows, d, h, composed):
    args = _route_inputs(rows, d, h, 3 * rows, composed)
    _check_leaves(cuda_sae.sae_topk_backward_plain(*args, composed),
                  cuda_sae._dense_topk_backward(*args, composed), composed)


@ROUTES
def test_plain_matches_dense_under_ties_at_the_kth_value(composed):
    """16 features with the same pre-activation head every row (zero
    encoder columns, equal biases): the select keeps all 16 at k = 8, so
    every row has twice k entries and 16 features every row selects."""
    rows, d, h = 96, 96, 352
    p = _params(5, d, h)
    p["w_enc"][:, :16] = 0.0
    p["b_enc"][:16] = 3.0
    args = _route_inputs(rows, d, h, 5, composed, p)
    assert bool(((args[0] > 0).sum(dim=1) == 16).all())
    _check_leaves(cuda_sae.sae_topk_backward_plain(*args, composed),
                  cuda_sae._dense_topk_backward(*args, composed), composed)


def test_sae_topk_backward_takes_the_plain_version_on_the_cpu():
    args = _exact_inputs(64, 96, 352, 7, False)
    before = (plain_calls["sae_topk_backward"], cuda_sae.sae_topk_backward.launches)
    got = cuda_sae.sae_topk_backward(*args, False)
    assert (plain_calls["sae_topk_backward"], cuda_sae.sae_topk_backward.launches) == (
        before[0] + 1, before[1])
    assert all(torch.equal(g, w) for g, w in
               zip(got, cuda_sae.sae_topk_backward_plain(*args, False)))


def _grads(fn, p, names=NAMES):
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = fn(q)
    out[0].backward()
    return out, {k: q[k].grad for k in names}


@pytest.mark.parametrize("d,h", [(96, 352), (160, 4096)])
def test_composed_loss_equals_autograd_on_the_cpu(d, h):
    """The composed route's autograd function, on the CPU (the encode's
    plain version, the dense products), gives the loss, l0, active vector
    and gradients -- the rows' too -- of autograd through
    ``topk_sae_apply`` bit for bit."""
    p = _params(9, d, h)
    p["x"] = torch.randn(128, d, generator=torch.Generator().manual_seed(10))
    got, g_got = _grads(lambda q: cuda_sae.composed_sae_loss(q["x"], *(q[n] for n in NAMES), K),
                        p, NAMES + ("x",))

    def autograd(q):
        out, active = tsae.topk_sae_apply(q, q["x"], K, torch.bfloat16)
        return out.loss, out.l0, active

    want, g_want = _grads(autograd, p, NAMES + ("x",))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for name in NAMES + ("x",):
        assert torch.equal(g_got[name], g_want[name]), name


@ROUTES
def test_routes_through_the_plain_backward_match_their_dense_backward(composed, monkeypatch):
    """Each route's autograd function with the plain version in the place
    of the card's entry: its gradients match the CPU route's dense ones
    (b_pre and b_dec share d_recon's sums; the rest as the leaves)."""
    d, h = (96, 352) if not composed else (160, 4096)
    p = _params(11, d, h)
    x = torch.randn(200, d, generator=torch.Generator().manual_seed(12))
    fn = cuda_sae.composed_sae_loss if composed else cuda_sae.fused_sae_loss

    def loss(q):
        return fn(x, *(q[n] for n in NAMES), K)

    _, dense = _grads(loss, p)
    monkeypatch.setattr(cuda_sae, "_backward_products", cuda_sae.sae_topk_backward)
    _, sparse = _grads(loss, p)
    assert torch.equal(sparse["b_dec"], dense["b_dec"])
    _check_leaves((sparse["w_enc"], sparse["b_enc"], sparse["w_dec"]),
                  (dense["w_enc"], dense["b_enc"], dense["w_dec"]), composed)
    top = float(dense["b_pre"].abs().max())
    assert float((sparse["b_pre"] - dense["b_pre"]).abs().max()) <= 2.0 ** -8 * top


def test_cpu_routes_keep_the_dense_backward(monkeypatch):
    """On the CPU both routes -- kernel A's and the composed loss -- run
    the dense products: neither reaches the sparse entry."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU route took the card's path")

    monkeypatch.setattr(cuda_sae, "sae_topk_backward", refuse)
    x = torch.randn(64, 96, generator=torch.Generator().manual_seed(13))
    for h in (352, 65536):  # kernel A's geometry, and past its 48 MiB (the composed route)
        q = {k: v.requires_grad_(True) for k, v in _params(14, 96, h).items()}
        loss, aux = tsae.topk_sae_loss(q, x, K, torch.bfloat16)
        loss.backward()
        assert all(q[n].grad is not None for n in NAMES) and float(aux["l0"]) == K
