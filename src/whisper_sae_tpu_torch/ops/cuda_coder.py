"""The coder kernel: one fused training forward for the transcoder, ReLU-SAE
and crosscoder families.

``coder_fwd`` (``csrc/coder_kernels.cu``, ``coder_rows_kernel<TOPK, SKIP,
Y_IS_X>``) replaces both launches of the Pallas body
``_fused_coder_kernel`` in ``whisper_sae_tpu/ops/pallas_sae.py``:
``_fused_coder_forward`` (``pallas_call`` at :679) and
``_fused_coder_forward_indexed`` (:1057), the latter as the same kernel
reading its batch at a row offset into the epoch buffers.  In one launch
it rounds the rows to bf16, encodes them, applies the exact top-k mask or
the ReLU, writes the bf16 latent, decodes it (plus the skip product),
writes the f32 residual against the target and reduces sum(resid^2), the
l0 count, the any-active vector and, in ReLU mode, sum(hid) and the
per-feature hidden sums; two small launches sum the per-CTA partials in
a fixed order.

The entry points keep the JAX names and the JAX parameter layout
(``w_enc [D, H]``, ``w_dec [H, dout]``, ``w_skip [D, dout]``):
``fused_transcoder_loss`` (TopK transcoder, Skip transcoder and, with
``y_is_x``, the TopK crosscoder on its flattened view),
``fused_relu_sae_loss``, ``fused_relu_crosscoder_loss`` and their
``*_indexed`` forms.  Each counts its launches in ``.launches``, and
``mode_launches`` counts them by (entry, mode).  A CUDA tensor goes to the
kernel (or the wrapper raises); a CPU tensor to the plain version beside
it, counted in ``plain_calls``.  The kernel holds a row of pre in one
warp's registers, so it takes H <= 3072 (:func:`coder_supported`, the
port's counterpart of ``fused_coder_supported``); wider geometries are
composed around the blocked encode by the models, as the JAX package
composes them.  The TPU's other gates (``pick_block_rows``, ``WST_*``)
have no counterpart.

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
from .topk import topk_mask_plain

mode_launches: Counter = Counter()
plain_calls: Counter = Counter()


def coder_supported(d: int, dout: int, h: int) -> bool:
    """The coder kernel holds the geometry: D, dout and H multiples of 32,
    H <= 3072."""
    return d % 32 == 0 and dout % 32 == 0 and h % 32 == 0 and h <= _build.MAX_ROW


def _bf16_t(w: torch.Tensor) -> torch.Tensor:
    """[K, N] weight -> its bf16 transpose [N, K], contiguous: the layout
    in which the kernel loads each MMA B fragment as two 32-bit words."""
    return w.detach().t().to(torch.bfloat16).contiguous()


class CoderOperands(NamedTuple):
    we_t: torch.Tensor          # [H, D] bf16
    b_enc: torch.Tensor         # [H] f32
    wd_t: torch.Tensor          # [dout, H] bf16
    b_out: torch.Tensor         # [dout] f32: b_dec (+ b_skip)
    ws_t: torch.Tensor | None   # [dout, D] bf16, or None without the skip path


class CoderOut(NamedTuple):
    sq: torch.Tensor             # sum(resid^2), f32 scalar
    l0: torch.Tensor             # count(hid > 0), scalar
    active: torch.Tensor         # [H] bool
    hid: torch.Tensor            # [B, H] bf16
    resid: torch.Tensor          # [B, dout] f32
    xc: torch.Tensor             # [B, D] bf16
    l1: torch.Tensor | None      # sum(hid), ReLU mode
    hsum: torch.Tensor | None    # [H] per-feature sum of hid, ReLU mode


def operands(w_enc, b_enc, w_dec, b_out, w_skip=None) -> CoderOperands:
    return CoderOperands(_bf16_t(w_enc), b_enc.detach(), _bf16_t(w_dec), b_out.detach(),
                         None if w_skip is None else _bf16_t(w_skip))


def coder_forward_plain(x: torch.Tensor, y: torch.Tensor | None, ops: CoderOperands,
                        k: int | None) -> CoderOut:
    """Plain PyTorch version of the kernel on the rows ``x`` and targets
    ``y`` (``None``: the rows themselves); ``k=None`` is ReLU mode."""
    xc = x.bfloat16()
    pre = mm_f32(xc, ops.we_t.t()) + ops.b_enc
    hidden = torch.relu(pre) if k is None else topk_mask_plain(pre, k)
    hid = hidden.bfloat16()
    pred = mm_f32(hid, ops.wd_t.t()) + ops.b_out
    if ops.ws_t is not None:
        pred = pred + mm_f32(xc, ops.ws_t.t())
    resid = pred - (x if y is None else y).float()
    pos = hidden > 0
    relu = k is None
    return CoderOut((resid * resid).sum(), pos.sum(), pos.any(dim=0), hid, resid, xc,
                    hidden.sum() if relu else None, hidden.sum(dim=0) if relu else None)


def _check(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    if (t.device != device or t.dtype not in dtypes or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {'/'.join(map(str, dtypes))} {shape} on {device} "
            f"(got {t.dtype} {tuple(t.shape)} on {t.device})"
        )


def _coder_launch(x, y, row_offset: int, rows: int, ops: CoderOperands, k: int | None) -> CoderOut:
    """The kernel on ``x[row_offset : row_offset + rows]`` (and the same rows
    of ``y``), CUDA only."""
    lib = _build.load_library()
    h, d = ops.we_t.shape
    dout = ops.wd_t.shape[0]
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
    if h > lib.wst_max_row_width():
        raise ValueError(f"the coder kernel holds a row in one warp's registers: "
                         f"H <= {lib.wst_max_row_width()} (got {h})")
    if k is not None and not 1 <= k <= h:
        raise ValueError(f"need 1 <= k <= H (got k={k}, H={h})")
    if rows <= 0 or row_offset < 0 or row_offset + rows > x.shape[0]:
        raise ValueError(f"window [{row_offset}, {row_offset + rows}) outside {x.shape[0]} rows")
    bf, f32 = (torch.bfloat16,), (torch.float32,)
    _check("w_enc_t", ops.we_t, dev, bf, (h, d))
    _check("b_enc", ops.b_enc, dev, f32, (h,))
    _check("w_dec_t", ops.wd_t, dev, bf, (dout, h))
    _check("b_out", ops.b_out, dev, f32, (dout,))
    if ops.ws_t is not None:
        _check("w_skip_t", ops.ws_t, dev, bf, (dout, d))
    relu = k is None
    blocks = -(-rows // lib.wst_coder_rows_per_cta())
    hid = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    resid = torch.empty((rows, dout), dtype=torch.float32, device=dev)
    xc = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    sq_partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
    l1_partial = torch.empty((blocks,), dtype=torch.float32, device=dev) if relu else None
    hsum_partial = torch.empty((blocks, h), dtype=torch.float32, device=dev) if relu else None
    hsum = torch.empty((h,), dtype=torch.float32, device=dev) if relu else None
    counts = torch.zeros((1 + h,), dtype=torch.int32, device=dev)
    sums = torch.empty((2,), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.wst_coder_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptr(y),
        int(y is not None and y.dtype == torch.bfloat16), row_offset, rows, d, h, dout,
        0 if relu else k, int(ops.ws_t is not None), int(y is None),
        ops.we_t.data_ptr(), ops.b_enc.data_ptr(), ops.wd_t.data_ptr(), ops.b_out.data_ptr(),
        ptr(ops.ws_t), hid.data_ptr(), resid.data_ptr(), xc.data_ptr(), sq_partial.data_ptr(),
        ptr(l1_partial), ptr(hsum_partial), counts.data_ptr(), sums.data_ptr(), ptr(hsum),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "coder_fwd")
    return CoderOut(sums[0], counts[0], counts[1:] > 0, hid, resid, xc,
                    sums[1] if relu else None, hsum)


def coder_forward(x, y, row_offset: int, rows: int, ops: CoderOperands, k: int | None,
                  entry, mode: str) -> CoderOut:
    """The kernel for CUDA rows, the plain version for CPU rows; ``entry``
    and ``mode`` name the launch in the counters."""
    if x.device.type == "cuda":
        out = _coder_launch(x, y, row_offset, rows, ops, k)
        entry.launches += 1
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
        ops = operands(w_enc, b_enc, w_dec, b_out, w_skip)
        mode = "skip_transcoder" if use_skip else ("topk_crosscoder" if y is None else "topk_transcoder")
        out = coder_forward(x, y, row_offset, rows, ops, k, entry, mode)
        dout = ops.wd_t.shape[0]
        loss = out.sq / (rows * dout)
        l0 = out.l0.float() / rows
        ctx.save_for_backward(out.hid, out.resid, out.xc, ops.we_t, ops.wd_t,
                              *(() if ops.ws_t is None else (ops.ws_t,)))
        ctx.meta = (row_offset, rows, use_skip, y is None)
        ctx.like = (_like(x), _like(y))
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(l0, out.active)
        return loss, l0, out.active, out.resid, out.hid

    @staticmethod
    def backward(ctx, gl, _g_l0, _g_active, g_resid, g_hid):
        hid, resid, xc, we_t, wd_t, *ws = ctx.saved_tensors
        row_offset, rows, use_skip, y_is_x = ctx.meta
        dout = resid.shape[1]
        d_pred = resid * (2.0 * _or0(gl) / (rows * dout))
        if g_resid is not None:
            d_pred = d_pred + g_resid
        dp_bf = d_pred.bfloat16()
        dhidden = mm_f32(dp_bf, wd_t)
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
    in ``fused_transcoder_loss.launches``."""
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
    ``fused_transcoder_loss_indexed.launches``."""
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
    Launches are counted in ``fused_relu_sae_loss.launches``."""
    return _ReluLoss.apply(x, 0, x.shape[0], w_enc, b_enc, w_dec, b_dec, None,
                           float(sparsity_weight), 1, fused_relu_sae_loss)


def fused_relu_sae_loss_indexed(buf, step, w_enc, b_enc, w_dec, b_dec, sparsity_weight, batch):
    """:func:`fused_relu_sae_loss` over ``buf[step*batch : (step+1)*batch]``
    at a row offset.  Launches: ``fused_relu_sae_loss_indexed.launches``."""
    return _ReluLoss.apply(buf, int(step) * batch, batch, w_enc, b_enc, w_dec, b_dec, None,
                           float(sparsity_weight), 1, fused_relu_sae_loss_indexed)


def fused_relu_crosscoder_loss(x, w_enc, b_enc, w_dec, b_dec, norms, sparsity_weight, n_layers):
    """(loss, recon_loss, sparsity_loss, l0, active) of a ReLU crosscoder on
    the flattened view, under AMP in one kernel.  x [B, L*D], w_enc
    [L*D, S], w_dec [S, L*D], b_dec [L*D]; ``norms`` [S] are the flat
    decoder norms, a differentiable input (its cotangent is c_sp * hsum,
    and autograd differentiates the norms themselves).  recon_loss = L x
    the flat MSE; sparsity = mean_b(hidden @ norms).  Launches are counted
    in ``fused_relu_crosscoder_loss.launches``."""
    return _ReluLoss.apply(x, 0, x.shape[0], w_enc, b_enc, w_dec, b_dec, norms,
                           float(sparsity_weight), int(n_layers), fused_relu_crosscoder_loss)


def fused_relu_crosscoder_loss_indexed(buf, step, w_enc, b_enc, w_dec, b_dec, norms,
                                       sparsity_weight, n_layers, batch):
    """:func:`fused_relu_crosscoder_loss` over ``buf[step*batch :
    (step+1)*batch]`` (the flattened [N, L*D] view) at a row offset.
    Launches: ``fused_relu_crosscoder_loss_indexed.launches``."""
    return _ReluLoss.apply(buf, int(step) * batch, batch, w_enc, b_enc, w_dec, b_dec, norms,
                           float(sparsity_weight), int(n_layers),
                           fused_relu_crosscoder_loss_indexed)


ENTRIES = (fused_transcoder_loss, fused_transcoder_loss_indexed, fused_relu_sae_loss,
           fused_relu_sae_loss_indexed, fused_relu_crosscoder_loss,
           fused_relu_crosscoder_loss_indexed)
for _entry in ENTRIES:
    _entry.launches = 0
