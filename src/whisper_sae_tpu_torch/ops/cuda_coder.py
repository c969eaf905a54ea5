"""The coder kernel: one fused training forward for the transcoder, ReLU-SAE
and crosscoder families.

``coder_fwd`` (``csrc/coder_kernels.cu``, one C call ``wst_coder_fwd``)
replaces both launches of the Pallas body ``_fused_coder_kernel`` in
``whisper_sae_tpu/ops/pallas_sae.py``: ``_fused_coder_forward``
(``pallas_call`` at :679) and ``_fused_coder_forward_indexed`` (:1057),
the latter as the same call reading its batch at a row offset into the
epoch buffers.  It rounds the rows to bf16, encodes them, applies the
exact top-k mask or the ReLU, writes the bf16 latent, decodes it (plus
the skip product), writes the f32 residual against the target and
reduces sum(resid^2), the l0 count, the any-active vector and, in ReLU
mode, sum(hid) and the per-feature hidden sums, the sums as partials
added in a fixed order.  Both families of modes start with the cast to
bf16 and run their products on the Hopper GEMM of
``csrc/encoder_gemm.cu``.  The TopK modes take kernel A's route: the
encode with the f32 pre-activation epilogue (``gemm_kernel<kPre>``), in
Skip mode a second one for the skip product, then a select-and-decode
row kernel (``coder_select_decode_kernel<SKIP, Y_IS_X>``: the exact
top-k, the latent and the sparse decode from the selected rows of
W_dec) and a sum (:func:`coder_topk_route_plain` transcribes that route).
The ReLU modes run the dense encode and decode (``gemm_kernel<kRelu>``,
``gemm_kernel<kResid>``) and two sums (:func:`coder_route_plain`).

The entry points keep the JAX names and the JAX parameter layout
(``w_enc [D, H]``, ``w_dec [H, dout]``, ``w_skip [D, dout]``):
``fused_transcoder_loss`` (TopK transcoder, Skip transcoder and, with
``y_is_x``, the TopK crosscoder on its flattened view),
``fused_relu_sae_loss``, ``fused_relu_crosscoder_loss`` and their
``*_indexed`` forms.  Each counts its launches in ``.launches``, those
past H = 3072 also in ``.wide_launches``, and ``mode_launches`` counts
them by (entry, mode).  A CUDA tensor goes to the kernel (or the wrapper
raises); a CPU tensor to the plain version beside it, counted in
``plain_calls``.

The kernel takes every geometry the JAX package fuses
(:func:`coder_supported`, the port's counterpart of
``fused_coder_supported``: bf16 W_enc + W_dec, plus W_skip with the skip
path, within the JAX package's 48 MiB).  The TopK modes' warp select
holds a row of pre in one warp's registers, H <= 3072; past it they take
the wide route, ``coder_wide_fwd`` (``wst_coder_wide_fwd``): the cast,
in Skip mode the skip product over all rows, then per chunk of kernel
B's rows the kPre encode and kernel A's wide select-and-decode in the
modes' form: ``coder_select_decode_group_kernel<N, SKIP, Y_IS_X>`` up to
H = 8192 (a warp group a row), ``coder_select_decode_wide_kernel`` past
it (one CTA a row; ``_build.wide_form``), and the sum over one partial a
row (:func:`coder_topk_route_plain` with ``per_row``).  The ReLU modes
run one route at every width.  Beyond
the budget (whisper-large 8x, whisper-tiny 128x) the models compose the
loss around the top-k encode, as the JAX package composes it.  The
TPU's other gates (``pick_block_rows``, ``WST_*``) have no counterpart.

Each backward transcribes its JAX custom VJP (``_fused_coder_vjp_bwd``
:758-799, ``_fused_relu_vjp_bwd`` :845-875, ``_fused_relu_cc_vjp_bwd``
:938-970 and the indexed ones at :1132-1286) as f32 products of bf16
operands (``mm_f32``), the counterpart of ``preferred_element_type=f32``.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from ..utils.device import mm_f32
from . import _build
from .cuda_sae import FUSED_W_BYTES, fixed_order_sum, group_row_sq, list_decode_plain
from .topk import relu as _relu, topk_mask_plain

mode_launches: Counter = Counter()
plain_calls: Counter = Counter()


def coder_supported(d: int, dout: int, h: int, with_skip: bool = False) -> bool:
    """The coder kernel takes the geometry (``pallas_sae.py:
    fused_coder_supported``): D, dout and H multiples of 32, bf16 W_enc +
    W_dec (+ W_skip ``with_skip``) within ``FUSED_W_BYTES``, H within the
    CTA select's row.  Whisper-tiny to 64x, base, small 8x and 16x,
    medium 8x; not whisper-large 8x or tiny 128x."""
    w_bytes = (d * h + h * dout + (d * dout if with_skip else 0)) * 2
    return (d % 32 == 0 and dout % 32 == 0 and h % 32 == 0 and w_bytes <= FUSED_W_BYTES
            and h <= _build.MAX_WIDE_ROW)


def uses_wide(h: int, k: int | None) -> bool:
    """A launch at width ``h`` takes the TopK modes' wide route: a row of
    pre wider than a warp's registers."""
    return k is not None and h > _build.MAX_ROW


def _bf16_t(w: torch.Tensor) -> torch.Tensor:
    """[K, N] weight -> its bf16 transpose [N, K], contiguous: the layout
    in which the kernel loads each MMA B fragment as two 32-bit words."""
    return w.detach().t().to(torch.bfloat16).contiguous()


class CoderOperands(NamedTuple):
    """The kernel's operands; W_dec in the layout its mode reads, once."""

    we_t: torch.Tensor          # [H, D] bf16
    b_enc: torch.Tensor         # [H] f32
    wd_t: torch.Tensor | None   # [dout, H] bf16: ReLU modes (the decode GEMM's B)
    b_out: torch.Tensor         # [dout] f32: b_dec (+ b_skip)
    ws_t: torch.Tensor | None = None   # [dout, D] bf16, or None without the skip path
    wd: torch.Tensor | None = None     # [H, dout] bf16: TopK modes (the rows the decode gathers)

    def w_dec(self) -> torch.Tensor:
        """W_dec [H, dout] bf16 (a view of ``wd_t`` in ReLU mode)."""
        return self.wd_t.t() if self.wd is None else self.wd


class CoderOut(NamedTuple):
    sq: torch.Tensor             # sum(resid^2), f32 scalar
    l0: torch.Tensor             # count(hid > 0), scalar
    active: torch.Tensor         # [H] bool
    hid: torch.Tensor            # [B, H] bf16
    resid: torch.Tensor          # [B, dout] f32
    xc: torch.Tensor             # [B, D] bf16
    l1: torch.Tensor | None      # sum(hid), ReLU mode
    hsum: torch.Tensor | None    # [H] per-feature sum of hid, ReLU mode


def operands(w_enc, b_enc, w_dec, b_out, w_skip=None, *, topk: bool = False) -> CoderOperands:
    """The bf16 copies a call reads: W_dec as ``wd`` [H, dout] for the
    TopK modes (``topk``), as ``wd_t`` [dout, H] for the ReLU modes."""
    wd = w_dec.detach().to(torch.bfloat16).contiguous() if topk else None
    return CoderOperands(_bf16_t(w_enc), b_enc.detach(), None if topk else _bf16_t(w_dec),
                         b_out.detach(), None if w_skip is None else _bf16_t(w_skip), wd)


def coder_forward_plain(x: torch.Tensor, y: torch.Tensor | None, ops: CoderOperands,
                        k: int | None) -> CoderOut:
    """Plain PyTorch version of the kernel on the rows ``x`` and targets
    ``y`` (``None``: the rows themselves); ``k=None`` is ReLU mode."""
    xc = x.bfloat16()
    pre = mm_f32(xc, ops.we_t.t()) + ops.b_enc
    hidden = _relu(pre) if k is None else topk_mask_plain(pre, k)
    hid = hidden.bfloat16()
    pred = mm_f32(hid, ops.w_dec()) + ops.b_out
    if ops.ws_t is not None:
        pred = pred + mm_f32(xc, ops.ws_t.t())
    resid = pred - (x if y is None else y).float()
    pos = hidden > 0
    relu = k is None
    return CoderOut((resid * resid).sum(), pos.sum(), pos.any(dim=0), hid, resid, xc,
                    hidden.sum() if relu else None, hidden.sum(dim=0) if relu else None)


def coder_route_plain(x: torch.Tensor, row_offset: int, rows: int,
                      ops: CoderOperands, tile: int) -> CoderOut:
    """The ReLU modes' CUDA route written out in plain PyTorch, for the
    tests, with the GEMM's output tile ``tile`` x ``tile`` (128:
    ``wst_gemm_tile()``): ``x[row_offset : row_offset + rows]`` to bf16,
    the encode on whole tiles of rows (rows past the window are zeros, so
    their pre-activation is b_enc) with the per-feature sums of each
    ``tile / 2`` rows and l0 over the window's rows alone, the decode and
    one sum(resid^2) a tile over those rows, then the partials added in
    the kernels' fixed orders (``coder_hsum_kernel``: the partial sums of
    a feature in row order; ``coder_sum_kernel``); a feature is active when
    its sum is positive.  Sums within a partial run in PyTorch's order,
    not the GEMM's."""
    half = tile // 2
    xw = x[row_offset:row_offset + rows]
    xc = xw.bfloat16()
    h = ops.we_t.shape[0]
    dout = ops.b_out.shape[0]
    padded = -(-rows // tile) * tile
    pre = torch.cat([mm_f32(xc, ops.we_t.t()) + ops.b_enc,
                     ops.b_enc.expand(padded - rows, h)])
    hidden = _relu(pre)
    valid = (torch.arange(padded) < rows)[:, None]
    counted = torch.where(valid, hidden, torch.zeros(()))
    parts = counted.view(padded // half, half, h).sum(dim=1)[:-(-rows // half)]
    hsum = torch.zeros(h, dtype=torch.float32)
    for p in parts:  # coder_hsum_kernel: row blocks in order
        hsum = hsum + p
    pos = (hidden > 0) & valid
    hid = hidden[:rows].bfloat16()  # the pad rows' decode is neither stored nor summed
    resid = mm_f32(hid, ops.wd_t.t()) + ops.b_out - xw.float()
    sq_tiles = torch.zeros(padded // tile, -(-dout // tile))
    for i in range(padded // tile):
        for j in range(sq_tiles.shape[1]):
            t = resid[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            sq_tiles[i, j] = (t * t).sum()
    return CoderOut(fixed_order_sum(sq_tiles.flatten()), pos.sum(), hsum > 0,
                    hid, resid, xc, fixed_order_sum(hsum), hsum)


def coder_topk_route_plain(x: torch.Tensor, y: torch.Tensor | None, row_offset: int, rows: int,
                           ops: CoderOperands, k: int, pass_cols: int,
                           per_row: bool = False) -> CoderOut:
    """The TopK modes' CUDA route written out in plain PyTorch, for the
    tests: ``x[row_offset : row_offset + rows]`` to bf16, the encode (the
    kPre product), in Skip mode the base ``xc @ W_skip + b_out`` first (the
    second kPre product), the exact top-k and the bf16 latent; then each
    row's decode from its selected rows of W_dec in feature order, in
    passes of ``pass_cols`` output columns (the warp form's 384; passes
    change no value), resid = (decode + base) - y (``y`` None: the rows
    themselves); one sum(resid^2) partial a CTA of ``_build.SEL_ROWS``
    rows, its rows added in order, each row's squares in PyTorch's order
    (the warp form's route), or with ``per_row`` one partial a row, its
    squares in the group form's order (:func:`cuda_sae.group_row_sq`: the
    wide route's at H <= ``_build.MAX_GROUP_ROW``; its chunks change no
    value); then the partials in ``coder_sum_kernel``'s fixed order."""
    win = slice(row_offset, row_offset + rows)
    xw = x[win]
    target = (xw if y is None else y[win]).float()
    xc = xw.bfloat16()
    pre = mm_f32(xc, ops.we_t.t()) + ops.b_enc
    base = (mm_f32(xc, ops.ws_t.t()) + ops.b_out if ops.ws_t is not None
            else ops.b_out.expand(rows, -1))
    hidden = topk_mask_plain(pre, k)
    hid = hidden.bfloat16()
    pos = hidden > 0
    resid = (list_decode_plain(hid, pos, ops.w_dec(), pass_cols) + base) - target
    if per_row:
        parts = group_row_sq(resid)
    else:
        per_cta = _build.SEL_ROWS
        row_sq = torch.zeros(-(-rows // per_cta) * per_cta, device=hid.device)
        row_sq[:rows] = (resid * resid).sum(dim=1)
        row_sq = row_sq.view(-1, per_cta)
        parts = row_sq[:, 0]
        for r in range(1, per_cta):
            parts = parts + row_sq[:, r]
    return CoderOut(fixed_order_sum(parts), pos.sum(), pos.any(dim=0), hid, resid, xc, None, None)


def _check(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    if (t.device != device or t.dtype not in dtypes or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {'/'.join(map(str, dtypes))} {shape} on {device} "
            f"(got {t.dtype} {tuple(t.shape)} on {t.device})"
        )


def _coder_launch(x, y, row_offset: int, rows: int, ops: CoderOperands, k: int | None,
                  wide: bool = False) -> CoderOut:
    """The kernel on ``x[row_offset : row_offset + rows]`` (and the same rows
    of ``y``), CUDA only; ``wide`` takes the TopK modes' wide route, which
    holds every H up to ``wst_max_wide_row_width()``, narrow ones too."""
    lib = _build.load_library()
    h, d = ops.we_t.shape
    dout = ops.b_out.shape[0]
    dev = x.device
    rows_t = (torch.float32, torch.bfloat16)
    if x.dim() != 2:
        raise ValueError("rows must be a 2-D tensor")
    _check("x", x, dev, rows_t, (x.shape[0], d))
    if y is not None:
        _check("y", y, dev, rows_t, (x.shape[0], dout))
    elif dout != d:
        raise ValueError(f"y = x needs dout == D (got {dout} and {d})")
    if d % 32 or h % 32 or dout % 32:
        raise ValueError(f"the coder kernel takes D, H and dout multiples of 32 (got {d}, {h}, {dout})")
    if h > lib.wst_max_wide_row_width():
        raise ValueError(f"the coder kernel's CTA select holds a row of pre in one CTA's "
                         f"registers: H <= {lib.wst_max_wide_row_width()} (got {h})")
    if wide and k is None:
        raise ValueError("the wide route is the TopK modes': the ReLU modes take every H")
    if k is not None and not wide and h > lib.wst_max_row_width():
        raise ValueError(f"the coder kernel's TopK warp select holds a row of pre in one warp's "
                         f"registers: H <= {lib.wst_max_row_width()} (got {h})")
    if k is not None and not 1 <= k <= h:
        raise ValueError(f"need 1 <= k <= H (got k={k}, H={h})")
    if rows <= 0 or row_offset < 0 or row_offset + rows > x.shape[0]:
        raise ValueError(f"window [{row_offset}, {row_offset + rows}) outside {x.shape[0]} rows")
    relu = k is None
    bf, f32 = (torch.bfloat16,), (torch.float32,)
    _check("w_enc_t", ops.we_t, dev, bf, (h, d))
    _check("b_enc", ops.b_enc, dev, f32, (h,))
    wd, wd_name, wd_shape = (ops.wd_t, "w_dec_t", (dout, h)) if relu else (ops.wd, "w_dec", (h, dout))
    if wd is None:
        raise ValueError(f"{'ReLU' if relu else 'TopK'} mode reads W_dec as {wd_name} {wd_shape}: "
                         f"operands(..., topk={not relu})")
    _check(wd_name, wd, dev, bf, wd_shape)
    _check("b_out", ops.b_out, dev, f32, (dout,))
    if ops.ws_t is not None:
        _check("w_skip_t", ops.ws_t, dev, bf, (dout, d))
    if relu and (y is not None or ops.ws_t is not None):
        raise ValueError("ReLU mode takes the rows as their own target and no skip path")
    # read 16 bytes at a time (x, by the cast) and by TMA (the GEMMs' weights)
    aligned = (("x", x), ("w_enc_t", ops.we_t), (wd_name, wd) if relu else ("w_skip_t", ops.ws_t))
    for name, t in aligned:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"coder_fwd: {name} must be 16-byte aligned")
    if wide and wd.data_ptr() % 4:  # the group form reads bf16 pairs
        raise ValueError("coder_wide_fwd: w_dec must be 4-byte aligned")
    hid = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    resid = torch.empty((rows, dout), dtype=torch.float32, device=dev)
    xc = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    sums = torch.empty((2,), dtype=torch.float32, device=dev)
    pre = hsum_partial = hsum = None
    if relu:
        tile = lib.wst_gemm_tile()  # the ReLU partials: one a tile, hsum one a half tile of rows
        sq_parts = -(-rows // tile) * -(-dout // tile)
        hsum_partial = torch.empty((-(-rows // (tile // 2)), h), dtype=torch.float32, device=dev)
        hsum = torch.empty((h,), dtype=torch.float32, device=dev)
        counts = torch.empty((1,), dtype=torch.int32, device=dev)  # l0; active: hsum > 0
    elif wide:  # one loss partial a row; the encode's workspace holds one chunk
        sq_parts = rows
        pre = torch.empty((min(rows, lib.wst_sae_topk_encode_chunk_rows(h)), h),
                          dtype=torch.float32, device=dev)
        counts = torch.empty((1 + h,), dtype=torch.int32, device=dev)  # l0, active
    else:
        sq_parts = -(-rows // lib.wst_rows_per_cta())
        pre = torch.empty((rows, h), dtype=torch.float32, device=dev)  # the encode's workspace
        counts = torch.empty((1 + h,), dtype=torch.int32, device=dev)  # l0, active
    sq_partial = torch.empty((sq_parts,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), ptr(y),
            int(y is not None and y.dtype == torch.bfloat16), row_offset, rows, d, h, dout,
            0 if relu else k, int(ops.ws_t is not None), int(y is None),
            ops.we_t.data_ptr(), ops.b_enc.data_ptr(), wd.data_ptr(), ops.b_out.data_ptr(),
            ptr(ops.ws_t), hid.data_ptr(), resid.data_ptr(), xc.data_ptr(), ptr(pre),
            sq_partial.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if wide:
        err, what = lib.wst_coder_wide_fwd(*head, counts.data_ptr(), sums.data_ptr(),
                                           stream), "coder_wide_fwd"
    else:
        err, what = lib.wst_coder_fwd(*head, ptr(hsum_partial), counts.data_ptr(),
                                      sums.data_ptr(), ptr(hsum), stream), "coder_fwd"
    _build.check(err, what)
    return CoderOut(sums[0], counts[0], hsum > 0 if relu else counts[1:] > 0, hid, resid, xc,
                    sums[1] if relu else None, hsum)


def coder_forward(x, y, row_offset: int, rows: int, ops: CoderOperands, k: int | None,
                  entry, mode: str) -> CoderOut:
    """The kernel for CUDA rows (the TopK modes' wide route past H =
    3072), the plain version for CPU rows; ``entry`` and ``mode`` name the
    launch in the counters."""
    if x.device.type == "cuda":
        h = ops.we_t.shape[0]
        out = _coder_launch(x, y, row_offset, rows, ops, k, uses_wide(h, k))
        entry.launches += 1
        entry.wide_launches += int(h > _build.MAX_ROW)
        mode_launches[(entry.__name__, mode)] += 1
        return out
    if x.device.type == "cpu":
        plain_calls[mode] += 1
        window = slice(row_offset, row_offset + rows)
        return coder_forward_plain(x[window], None if y is None else y[window], ops, k)
    raise ValueError(f"coder kernel: unsupported device {x.device}")


def _like(t: torch.Tensor | None):
    return None if t is None else (t.shape, t.dtype)


def _scatter_rows(rows_grad: torch.Tensor, window, like) -> torch.Tensor:
    """A window's gradient placed into zeros of the whole buffer's
    ``like = (shape, dtype)``."""
    row_offset, rows = window
    shape, dtype = like
    full = torch.zeros(shape, dtype=torch.float32, device=rows_grad.device)
    full[row_offset:row_offset + rows] = rows_grad
    return full.to(dtype)


def _or0(g):
    return 0.0 if g is None else g


# ---------------------------------------------------------------------------
# TopK / Skip transcoder, and the TopK crosscoder on its flattened view
# ---------------------------------------------------------------------------


class _TranscoderLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, row_offset, rows, w_enc, b_enc, w_dec, b_dec, w_skip, b_skip, k,
                entry):
        use_skip = w_skip is not None
        b_out = b_dec + b_skip if use_skip else b_dec
        ops = operands(w_enc, b_enc, w_dec, b_out, w_skip, topk=True)
        mode = "skip_transcoder" if use_skip else ("topk_crosscoder" if y is None else "topk_transcoder")
        out = coder_forward(x, y, row_offset, rows, ops, k, entry, mode)
        dout = ops.b_out.shape[0]
        loss = out.sq / (rows * dout)
        l0 = out.l0.float() / rows
        ctx.save_for_backward(out.hid, out.resid, out.xc, ops.we_t, ops.wd,
                              *(() if ops.ws_t is None else (ops.ws_t,)))
        ctx.meta = (row_offset, rows, use_skip, y is None)
        ctx.like = (_like(x), _like(y))
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(l0, out.active)
        return loss, l0, out.active, out.resid, out.hid

    @staticmethod
    def backward(ctx, gl, _g_l0, _g_active, g_resid, g_hid):
        hid, resid, xc, we_t, wd, *ws = ctx.saved_tensors
        row_offset, rows, use_skip, y_is_x = ctx.meta
        dout = resid.shape[1]
        d_pred = resid * (2.0 * _or0(gl) / (rows * dout))
        if g_resid is not None:
            d_pred = d_pred + g_resid
        dp_bf = d_pred.bfloat16()
        dhidden = mm_f32(dp_bf, wd.t())
        if g_hid is not None:
            dhidden = dhidden + g_hid.float()
        dpre = torch.where(hid > 0, dhidden, torch.zeros((), device=dhidden.device))
        dpre_bf = dpre.bfloat16()
        dw_enc = mm_f32(xc.t(), dpre_bf)
        db_enc = dpre.sum(dim=0)  # f32 sums: a bf16 reduction loses ~1e-3
        dw_dec = mm_f32(hid.t(), dp_bf)
        db_dec = d_pred.sum(dim=0)
        dw_skip = db_skip = None
        if use_skip:
            dw_skip = mm_f32(xc.t(), dp_bf)
            db_skip = db_dec  # b_dec and b_skip enter the prediction identically
        dx = dy = None
        x, y = ctx.like
        window = (row_offset, rows)
        if ctx.needs_input_grad[0]:
            d_rows = mm_f32(dpre_bf, we_t)
            if use_skip:
                d_rows = d_rows + mm_f32(dp_bf, ws[0])
            if y_is_x:  # the rows are their own target
                d_rows = d_rows - d_pred
            dx = _scatter_rows(d_rows, window, x)
        if not y_is_x and ctx.needs_input_grad[1]:
            dy = _scatter_rows(-d_pred, window, y)
        return (dx, dy, None, None, dw_enc, db_enc, dw_dec, db_dec, dw_skip, db_skip, None, None)


def fused_transcoder_loss(x, y, w_enc, b_enc, w_dec, b_dec, w_skip, b_skip, k, use_skip,
                          y_is_x=False):
    """(loss, l0, active, resid, hidden_bf16) of a TopK/Skip transcoder under
    AMP in one kernel: loss = mean((topk_mask(relu(bf16(x) @ W_enc + b_enc))
    @ W_dec + b_dec [+ bf16(x) @ W_skip + b_skip] - y)^2), the decode
    consuming the bf16 latent.  ``use_skip=False`` ignores ``w_skip`` and
    ``b_skip``; ``y_is_x`` takes the rows as their own target (the TopK
    crosscoder's flattened view) and ignores ``y``.  The backward honours
    the cotangents of ``resid`` and ``hidden`` too.  Launches are counted
    in ``fused_transcoder_loss.launches``, those past H = 3072 (the wide
    route) also in ``.wide_launches``."""
    return _TranscoderLoss.apply(
        x, None if y_is_x else y, 0, x.shape[0], w_enc, b_enc, w_dec, b_dec,
        w_skip if use_skip else None, b_skip if use_skip else None, k, fused_transcoder_loss,
    )


def fused_transcoder_loss_indexed(xbuf, ybuf, step, w_enc, b_enc, w_dec, b_dec, w_skip, b_skip,
                                  k, batch, use_skip, y_is_x=False):
    """:func:`fused_transcoder_loss` over the windows ``xbuf/ybuf[step*batch :
    (step+1)*batch]``, read by the kernel at a row offset (no slice is
    copied).  Returns (loss, l0, active); the buffers are not
    differentiated.  Launches are counted in
    ``fused_transcoder_loss_indexed.launches`` (and ``.wide_launches``)."""
    loss, l0, active, _, _ = _TranscoderLoss.apply(
        xbuf, None if y_is_x else ybuf, int(step) * batch, batch, w_enc, b_enc, w_dec, b_dec,
        w_skip if use_skip else None, b_skip if use_skip else None, k,
        fused_transcoder_loss_indexed,
    )
    return loss, l0, active


# ---------------------------------------------------------------------------
# ReLU SAE and ReLU crosscoder (ReLU mode, y = x)
# ---------------------------------------------------------------------------


class _ReluLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_offset, rows, w_enc, b_enc, w_dec, b_dec, norms, sparsity_weight,
                n_layers, entry):
        ops = operands(w_enc, b_enc, w_dec, b_dec)
        mode = "relu_sae" if norms is None else "relu_crosscoder"
        out = coder_forward(x, None, row_offset, rows, ops, None, entry, mode)
        h, d = ops.we_t.shape
        flat = out.sq / (rows * d)
        if norms is None:  # ReLU SAE: mse + sw * mean(hid)
            recon = flat
            sparsity = out.l1 / (rows * h)
        else:  # sum of per-layer MSEs, decoder-norm-weighted L1
            recon = n_layers * flat
            sparsity = torch.dot(out.hsum, norms.detach()) / rows
        loss = recon + sparsity_weight * sparsity
        l0 = out.l0.float() / rows
        saved = (out.hid, out.resid, out.xc, ops.we_t, ops.wd_t)
        if norms is not None:
            saved += (norms.detach(), out.hsum)
        ctx.save_for_backward(*saved)
        ctx.meta = (row_offset, rows, sparsity_weight, n_layers, norms is not None)
        ctx.like = _like(x)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(l0, out.active)
        return loss, recon, sparsity, l0, out.active

    @staticmethod
    def backward(ctx, gl, g_rec, g_sp, _g_l0, _g_active):
        hid, resid, xc, we_t, wd_t, *cc = ctx.saved_tensors
        row_offset, rows, sw, n_layers, crosscoder = ctx.meta
        gl, g_rec, g_sp = _or0(gl), _or0(g_rec), _or0(g_sp)
        h = hid.shape[1]
        d = resid.shape[1]
        zero = torch.zeros((), device=resid.device)
        dnorms = None
        if crosscoder:
            norms, hsum = cc
            c_rec = 2.0 * n_layers * (gl + g_rec) / (rows * d)
            c_sp = (gl * sw + g_sp) / rows
            d_pred = resid * c_rec
            dp_bf = d_pred.bfloat16()
            dhidden = mm_f32(dp_bf, wd_t) + c_sp * norms[None, :]
            # hidden >= 0 under ReLU, so the relu gate is exactly hid > 0
            dpre = torch.where(hid > 0, dhidden, zero)
            dnorms = c_sp * hsum
        else:
            d_pred = resid * (2.0 * (gl + g_rec) / (rows * d))
            dp_bf = d_pred.bfloat16()
            dhidden = mm_f32(dp_bf, wd_t)
            # d/dh of mean(h) adds a constant on active entries
            dpre = torch.where(hid > 0, dhidden + (gl * sw + g_sp) / (rows * h), zero)
        dpre_bf = dpre.bfloat16()
        dw_enc = mm_f32(xc.t(), dpre_bf)
        db_enc = dpre.sum(dim=0)
        dw_dec = mm_f32(hid.t(), dp_bf)
        db_dec = d_pred.sum(dim=0)
        dx = None
        if ctx.needs_input_grad[0]:  # x is both the encode input and the target
            dx = _scatter_rows(mm_f32(dpre_bf, we_t) - d_pred, (row_offset, rows), ctx.like)
        return (dx, None, None, dw_enc, db_enc, dw_dec, db_dec, dnorms, None, None, None)


def fused_relu_sae_loss(x, w_enc, b_enc, w_dec, b_dec, sparsity_weight):
    """(loss, recon_loss, sparsity_loss, l0, active) of a ReLU + L1 SAE under
    AMP in one kernel: recon = relu(bf16(x) @ W_enc + b_enc) @ W_dec + b_dec
    on the bf16 latent, loss = mean((recon - x)^2) + sw * mean(hidden).
    Launches are counted in ``fused_relu_sae_loss.launches``, those past
    H = 3072 also in ``.wide_launches`` (the same route at every width)."""
    return _ReluLoss.apply(x, 0, x.shape[0], w_enc, b_enc, w_dec, b_dec, None,
                           float(sparsity_weight), 1, fused_relu_sae_loss)


def fused_relu_sae_loss_indexed(buf, step, w_enc, b_enc, w_dec, b_dec, sparsity_weight, batch):
    """:func:`fused_relu_sae_loss` over ``buf[step*batch : (step+1)*batch]``
    at a row offset.  Launches: ``fused_relu_sae_loss_indexed.launches``
    (and ``.wide_launches``)."""
    return _ReluLoss.apply(buf, int(step) * batch, batch, w_enc, b_enc, w_dec, b_dec, None,
                           float(sparsity_weight), 1, fused_relu_sae_loss_indexed)


def fused_relu_crosscoder_loss(x, w_enc, b_enc, w_dec, b_dec, norms, sparsity_weight, n_layers):
    """(loss, recon_loss, sparsity_loss, l0, active) of a ReLU crosscoder on
    the flattened view, under AMP in one kernel.  x [B, L*D], w_enc
    [L*D, S], w_dec [S, L*D], b_dec [L*D]; ``norms`` [S] are the flat
    decoder norms, a differentiable input (its cotangent is c_sp * hsum,
    and autograd differentiates the norms themselves).  recon_loss = L x
    the flat MSE; sparsity = mean_b(hidden @ norms).  Launches are counted
    in ``fused_relu_crosscoder_loss.launches`` (and ``.wide_launches``)."""
    return _ReluLoss.apply(x, 0, x.shape[0], w_enc, b_enc, w_dec, b_dec, norms,
                           float(sparsity_weight), int(n_layers), fused_relu_crosscoder_loss)


def fused_relu_crosscoder_loss_indexed(buf, step, w_enc, b_enc, w_dec, b_dec, norms,
                                       sparsity_weight, n_layers, batch):
    """:func:`fused_relu_crosscoder_loss` over ``buf[step*batch :
    (step+1)*batch]`` (the flattened [N, L*D] view) at a row offset.
    Launches: ``fused_relu_crosscoder_loss_indexed.launches`` (and
    ``.wide_launches``)."""
    return _ReluLoss.apply(buf, int(step) * batch, batch, w_enc, b_enc, w_dec, b_dec, norms,
                           float(sparsity_weight), int(n_layers),
                           fused_relu_crosscoder_loss_indexed)


ENTRIES = (fused_transcoder_loss, fused_transcoder_loss_indexed, fused_relu_sae_loss,
           fused_relu_sae_loss_indexed, fused_relu_crosscoder_loss,
           fused_relu_crosscoder_loss_indexed)
for _entry in ENTRIES:
    _entry.launches = _entry.wide_launches = 0
