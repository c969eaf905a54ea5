"""Kernels A and B: the fused TopK-SAE forward and the fused top-k encode.

Kernel A, ``sae_fused_loss_fwd`` (``csrc/sae_kernels.cu``,
``sae_rows_kernel<kFusedLoss>``), replaces two Pallas entry points of
``whisper_sae_tpu/ops/pallas_sae.py``: ``fused_sae_loss``
(``_fused_loss_forward``, ``pallas_call`` at :249) and
``fused_sae_loss_indexed`` (``_fused_loss_forward_indexed``, :424), the
latter as the same kernel reading its batch at a row offset into the
epoch buffer.  In one launch it centres the rows, encodes them, finds
the exact top-k threshold, writes the bf16 latent, decodes from the
selected decoder rows only and reduces sum(resid^2), l0 and the
any-active vector (a second, one-CTA launch sums the per-CTA loss
partials in a fixed order).

Kernel B, ``sae_topk_encode_fwd`` (``sae_rows_kernel<kEncodeBf16|F32>``),
replaces ``fused_topk_encode`` (``_encode_forward``, :77): the encode and
bisection stages of A alone, writing the hidden in bf16 or f32.

Bound on the H100 at whisper-tiny (D=384, H=3072): both are bound by the
bytes they must move (see the note in ``csrc/sae_kernels.cu``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain PyTorch version beside it only for CPU tensors.  Each backward
transcribes the JAX custom VJP (``_fused_loss_vjp_bwd`` :321-353,
``_fused_loss_indexed_vjp_bwd`` :490-517, ``_bwd`` :123-143) as f32
products of bf16 operands (``mm_f32``), the counterpart of
``preferred_element_type=f32``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.device import mm_f32
from . import _build
from .topk import topk_mask_plain


def _bf16_t(w_enc: torch.Tensor) -> torch.Tensor:
    """W_enc [D, H] -> its bf16 transpose [H, D], the layout in which the
    kernel loads each MMA B fragment as two 32-bit words."""
    return w_enc.detach().t().to(torch.bfloat16, memory_format=torch.contiguous_format)


def _check_geometry(x: torch.Tensor, d: int, h: int, k: int) -> ctypes.CDLL:
    lib = _build.load_library()
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("rows must be a contiguous 2-D float32 or bfloat16 tensor")
    if x.shape[1] != d:
        raise ValueError(f"rows have width {x.shape[1]}, weights expect D={d}")
    if d % 32 or d > lib.wst_max_d():
        raise ValueError(f"the SAE kernels take D a multiple of 32 and <= {lib.wst_max_d()} (got {d})")
    if h % 32 or h > lib.wst_max_row_width():
        raise ValueError(
            f"the SAE kernels take H a multiple of 32 and <= {lib.wst_max_row_width()} (got {h})"
        )
    if not 1 <= k <= h:
        raise ValueError(f"need 1 <= k <= H (got k={k}, H={h})")
    return lib


def _check_operands(device: torch.device, **operands) -> None:
    """Each operand is ``(tensor, dtype, shape)``: the kernel reads it raw."""
    for name, (t, dtype, shape) in operands.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} {shape} on {device} "
                f"(got {t.dtype} {tuple(t.shape)} on {t.device})"
            )


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# kernel A: fused loss forward
# ---------------------------------------------------------------------------


def fused_sae_loss_plain(x, we_t, b_enc, b_pre, wd_bf, b_out, k):
    """Plain PyTorch version of kernel A on the rows ``x``.

    Returns (loss, l0, active, hid bf16, resid f32, xc bf16)."""
    b, d = x.shape
    xc = (x.float() - b_pre).bfloat16()
    pre = mm_f32(xc, we_t.t()) + b_enc
    hidden = topk_mask_plain(pre, k)
    hid = hidden.bfloat16()
    resid = (mm_f32(hid, wd_bf) + b_out) - x.float()
    pos = hidden > 0
    loss = (resid * resid).sum() / (b * d)
    l0 = pos.sum().float() / b
    return loss, l0, pos.any(dim=0), hid, resid, xc


def _fused_loss_launch(data, row_offset, rows, we_t, b_enc, b_pre, wd_bf, b_out, k):
    """Kernel A on ``data[row_offset : row_offset + rows]`` (CUDA only)."""
    h, d = we_t.shape
    lib = _check_geometry(data, d, h, k)
    if not 0 < rows or row_offset < 0 or row_offset + rows > data.shape[0]:
        raise ValueError(f"window [{row_offset}, {row_offset + rows}) outside {data.shape[0]} rows")
    dev = data.device
    bf, f32 = torch.bfloat16, torch.float32
    _check_operands(dev, w_enc_t=(we_t, bf, (h, d)), w_dec=(wd_bf, bf, (h, d)),
                    b_enc=(b_enc, f32, (h,)), b_pre=(b_pre, f32, (d,)), b_out=(b_out, f32, (d,)))
    blocks = -(-rows // lib.wst_rows_per_cta())
    hid = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    resid = torch.empty((rows, d), dtype=torch.float32, device=dev)
    xc = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
    counts = torch.zeros((1 + h,), dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    l0 = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.wst_sae_fused_loss_fwd(
        data.data_ptr(), int(data.dtype == torch.bfloat16), row_offset, rows, d, h, k,
        we_t.data_ptr(), b_enc.data_ptr(), b_pre.data_ptr(), wd_bf.data_ptr(), b_out.data_ptr(),
        hid.data_ptr(), resid.data_ptr(), xc.data_ptr(), partial.data_ptr(), counts.data_ptr(),
        loss.data_ptr(), l0.data_ptr(), _stream(dev),
    )
    _build.check(err, "sae_fused_loss_fwd")
    return loss, l0, counts[1:] > 0, hid, resid, xc


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_offset, rows, w_enc, b_enc, b_pre, w_dec, b_dec, k, entry):
        we_t = _bf16_t(w_enc)
        wd_bf = w_dec.detach().to(torch.bfloat16)
        b_out = b_dec + b_pre
        if data.device.type == "cuda":
            loss, l0, active, hid, resid, xc = _fused_loss_launch(
                data, row_offset, rows, we_t, b_enc, b_pre, wd_bf, b_out, k
            )
            entry.launches += 1
        elif data.device.type == "cpu":
            loss, l0, active, hid, resid, xc = fused_sae_loss_plain(
                data[row_offset:row_offset + rows], we_t, b_enc, b_pre, wd_bf, b_out, k
            )
        else:
            raise ValueError(f"fused SAE loss: unsupported device {data.device}")
        ctx.save_for_backward(hid, resid, xc, we_t, wd_bf)
        ctx.window = (row_offset, rows, data.shape[0], data.dtype)
        ctx.mark_non_differentiable(l0, active)
        return loss, l0, active

    @staticmethod
    def backward(ctx, g_loss, _g_l0, _g_active):
        hid, resid, xc, we_t, wd_bf = ctx.saved_tensors
        b, d = resid.shape
        d_recon = resid * (2.0 * g_loss / (b * d))
        drec_bf = d_recon.bfloat16()
        dhidden = mm_f32(drec_bf, wd_bf.t())
        # bf16 rounding keeps the sign, so hid > 0 is the f32 selection
        dpre = torch.where(hid > 0, dhidden, torch.zeros((), device=dhidden.device))
        dpre_bf = dpre.bfloat16()
        dw_enc = mm_f32(xc.t(), dpre_bf)
        db_enc = dpre.sum(dim=0)  # f32 sums: a bf16 reduction loses ~1e-3
        dw_dec = mm_f32(hid.t(), drec_bf)
        db_dec = d_recon.sum(dim=0)
        # b_pre enters twice: +recon and -encode input
        db_pre = db_dec - mm_f32(db_enc[None], we_t)[0]
        dx = None
        if ctx.needs_input_grad[0]:
            row_offset, rows, n, dtype = ctx.window
            d_rows = mm_f32(dpre_bf, we_t) - d_recon
            dx = torch.zeros((n, d), dtype=torch.float32, device=d_rows.device)
            dx[row_offset:row_offset + rows] = d_rows
            dx = dx.to(dtype)
        return dx, None, None, dw_enc, db_enc, db_pre, dw_dec, db_dec, None, None


def fused_sae_loss(x, w_enc, b_enc, b_pre, w_dec, b_dec, k):
    """(loss, l0, active) of a TopK SAE under AMP in one kernel.

    loss = mean((topk_mask(relu(bf16(x - b_pre) @ W_enc + b_enc)) @ W_dec
    + b_dec + b_pre - x)^2) with the decode consuming the bf16 latent;
    l0 = mean active count per row; active = any-over-batch per feature.
    Launches are counted in ``fused_sae_loss.launches``."""
    return _FusedLoss.apply(
        x, 0, x.shape[0], w_enc, b_enc, b_pre, w_dec, b_dec, k, fused_sae_loss
    )


def fused_sae_loss_indexed(data, step, w_enc, b_enc, b_pre, w_dec, b_dec, k, batch):
    """:func:`fused_sae_loss` over ``data[step*batch : (step+1)*batch]``,
    read by the kernel at a row offset into the epoch buffer (no slice is
    copied).  ``data`` is not differentiated.  Launches are counted in
    ``fused_sae_loss_indexed.launches``."""
    return _FusedLoss.apply(
        data, int(step) * batch, batch, w_enc, b_enc, b_pre, w_dec, b_dec, k,
        fused_sae_loss_indexed,
    )


fused_sae_loss.launches = 0
fused_sae_loss_indexed.launches = 0


# ---------------------------------------------------------------------------
# kernel B: fused top-k encode
# ---------------------------------------------------------------------------


def topk_encode_plain(x, we_t, b_enc, b_pre, k, out_dtype):
    """Plain PyTorch version of kernel B."""
    xc = (x.float() - b_pre).bfloat16()
    pre = mm_f32(xc, we_t.t()) + b_enc
    return topk_mask_plain(pre, k).to(out_dtype)


def _topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype):
    h, d = we_t.shape
    lib = _check_geometry(x, d, h, k)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"sae_topk_encode_fwd writes bf16 or f32 (got {out_dtype})")
    dev = x.device
    _check_operands(dev, w_enc_t=(we_t, torch.bfloat16, (h, d)),
                    b_enc=(b_enc, torch.float32, (h,)), b_pre=(b_pre, torch.float32, (d,)))
    rows = x.shape[0]
    hidden = torch.empty((rows, h), dtype=out_dtype, device=dev)
    if rows:
        err = lib.wst_sae_topk_encode_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d, h, k,
            we_t.data_ptr(), b_enc.data_ptr(), b_pre.data_ptr(), hidden.data_ptr(),
            int(out_dtype == torch.float32), _stream(dev),
        )
        _build.check(err, "sae_topk_encode_fwd")
        fused_topk_encode.launches += 1
    return hidden


class _TopKEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_enc, b_enc, b_pre, k, out_dtype):
        we_t = _bf16_t(w_enc)
        if x.device.type == "cuda":
            hidden = _topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype)
        elif x.device.type == "cpu":
            hidden = topk_encode_plain(x, we_t, b_enc, b_pre, k, out_dtype)
        else:
            raise ValueError(f"fused top-k encode: unsupported device {x.device}")
        ctx.save_for_backward(x, we_t, b_pre, hidden)
        return hidden

    @staticmethod
    def backward(ctx, g):
        x, we_t, b_pre, hidden = ctx.saved_tensors
        # the gradient reaches exactly the selected positive entries
        dpre = torch.where(hidden > 0, g.float(), torch.zeros((), device=g.device))
        dpre_bf = dpre.bfloat16()
        xc_bf = (x.float() - b_pre).bfloat16()
        dw = mm_f32(xc_bf.t(), dpre_bf)
        db_enc = dpre.sum(dim=0)
        db_pre = -mm_f32(db_enc[None], we_t)[0]
        dx = mm_f32(dpre_bf, we_t).to(x.dtype) if ctx.needs_input_grad[0] else None
        return dx, dw, db_enc, db_pre, None, None


def fused_topk_encode(x, w_enc, b_enc, b_pre, k, out_dtype=torch.bfloat16):
    """hidden = topk_mask(relu(bf16(x - b_pre) @ W_enc + b_enc), k) in
    ``out_dtype``.  Launches are counted in ``fused_topk_encode.launches``."""
    return _TopKEncode.apply(x, w_enc, b_enc, b_pre, k, out_dtype)


fused_topk_encode.launches = 0
