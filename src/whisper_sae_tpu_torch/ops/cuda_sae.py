"""Kernels A and B and the blocked encode: the fused TopK-SAE forward and
the fused top-k encode.

Kernel A, ``sae_fused_loss_fwd`` (``csrc/sae_kernels.cu``), replaces two
Pallas entry points of ``whisper_sae_tpu/ops/pallas_sae.py``:
``fused_sae_loss`` (``_fused_loss_forward``, ``pallas_call`` at :249)
and ``fused_sae_loss_indexed`` (``_fused_loss_forward_indexed``, :424),
the latter reading its batch at a row offset into the epoch buffer.  One
C call launches four kernels: ``sae_centre_kernel`` writes the centred
bf16 rows; the encoder GEMM (``csrc/encoder_gemm.cu``, warp-specialised
TMA/wgmma) with its ``kPre`` epilogue writes the f32 pre-activation to a
workspace allocated here; ``sae_select_decode_kernel`` (one warp a row)
finds the exact top-k threshold, writes the bf16 latent, decodes from
the selected decoder rows only and reduces sum(resid^2), l0 and the
any-active vector; ``sae_loss_finalize_kernel`` sums the per-CTA loss
partials in a fixed order.  The f32 pre's round trip through device
memory is the route's price (the TPU kernel keeps it in VMEM).

Kernel B, ``sae_topk_encode_fwd``, and the blocked encode,
``blocked_encode_fwd`` (both in ``csrc/blocked_encode.cu``), are one
chunk loop with two selects: per chunk of rows the centre
(``sae_centre_kernel``), the encoder GEMM's kPre epilogue into an f32
workspace allocated here, and a select that writes the latent in bf16
or f32 (:func:`topk_encode_route_plain` writes the route out).  Kernel B
replaces ``fused_topk_encode`` (``_encode_forward``, :77); its select is
kernel C's warp select (one warp a row), its chunk the rows whose f32 pre
fits the blocked encode's budget (:func:`_build.topk_encode_chunk_rows`:
27,264 at H = 3072).  The blocked encode replaces
``_encode_forward_blocked`` (:1392), the branch of ``fused_topk_encode``
for geometries whose weights do not fit on chip; its select is one CTA
a row, its chunk 2048 rows, and W_enc streams once a chunk.  Kernel B
and kernel A's warp form hold a row of pre in one warp's registers and
A's decode keeps D/32 sums a lane, so they take D % 32 == 0, D <= 384
and H <= 3072 (:func:`row_kernels_hold`); the top-k encode takes the
blocked encode at every other geometry (:func:`uses_blocked`).  Kernel A
also has a wide route, ``sae_fused_loss_wide_fwd``: the centre, then per
chunk of kernel B's rows the kPre encode and the select-and-decode,
then the finalize over one partial a row.  The select-and-decode is the
group form up to H = 8192 (``sae_select_decode_group_kernel``:
persistent CTAs of warp groups, a group a row on its own named barrier,
the next row's pre brought into shared memory by a bulk copy, the
decode over the group's warps two columns a thread;
:func:`fused_loss_wide_route_plain` writes it out), past it the
CTA-per-row form (``sae_select_decode_wide_kernel``: one CTA a row, the
decode's warps over D in 32-column tiles); ``_build.wide_form`` names
the form of a width.
Kernel A takes every geometry the JAX package fuses
(:func:`fused_loss_supported`: bf16 W_enc + W_dec within its 48 MiB,
``pallas_sae.py:359-365``), through its warp form where
:func:`row_kernels_hold`, else through the wide route; beyond that budget
(whisper-large) the SAE loss is composed around the blocked encode
(``models/sae.py``), as the JAX package composes it
(``models/sae.py:229-246``).

Bounds on the H100: A and B at whisper-tiny (D=384, H=3072) by the bytes
they must move, A's wide route at whisper-small 8x by operations (the
notes in ``csrc/sae_kernels.cu`` and ``csrc/blocked_encode.cu``); the
blocked encode at whisper-large 32x by operations
(``csrc/blocked_encode.cu``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain PyTorch version beside it only for CPU tensors, counted in
``ops.topk.plain_calls``.  Each backward transcribes the JAX custom VJP
(``_fused_loss_vjp_bwd`` :321-353, ``_fused_loss_indexed_vjp_bwd``
:490-517, ``_bwd`` :123-143) as f32 products of bf16 operands
(``mm_f32``), the counterpart of ``preferred_element_type=f32``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.device import mm_f32
from . import _build
from .topk import cta_threshold, group_threshold, plain_calls, relu, topk_mask_plain


# bf16 W_enc + W_dec at most: the JAX package's budget for the fused
# training forward (``pallas_sae.py:_MAX_W_VMEM_BYTES``, :1428), kept so
# that the port fuses where the JAX package fuses
FUSED_W_BYTES = 48 * 1024 * 1024


def fused_loss_supported(d: int, h: int) -> bool:
    """Kernel A takes the geometry (``pallas_sae.py:fused_loss_supported``):
    D and H multiples of 32, bf16 W_enc + W_dec within ``FUSED_W_BYTES``,
    H within the CTA select's row (whisper-tiny to 64x, base 8x and 32x,
    small 8x and 16x, medium 8x; not whisper-large)."""
    return (d % 32 == 0 and h % 32 == 0 and 4 * d * h <= FUSED_W_BYTES
            and h <= _build.MAX_WIDE_ROW)


def row_kernels_hold(d: int, h: int) -> bool:
    """Kernel B and kernel A's warp form hold the geometry: D a multiple
    of 32 up to 384 (kernel A's one decode pass), H a multiple of 32 up to
    3072 (a row in one warp's registers)."""
    return d % 32 == 0 and h % 32 == 0 and d <= _build.MAX_D and h <= _build.MAX_ROW


def uses_blocked(d: int, h: int) -> bool:
    """The top-k encode takes the blocked kernel (``pallas_sae.py:69-75``)."""
    return not row_kernels_hold(d, h)


def _bf16_t(w_enc: torch.Tensor) -> torch.Tensor:
    """W_enc [D, H] -> its bf16 transpose [H, D]: the K-major B operand of
    the encode GEMM (kernels A and B, the blocked encode), read by TMA."""
    return w_enc.detach().t().to(torch.bfloat16, memory_format=torch.contiguous_format)


def _check_rows(x: torch.Tensor, d: int, h: int, k: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("rows must be a contiguous 2-D float32 or bfloat16 tensor")
    if x.shape[1] != d:
        raise ValueError(f"rows have width {x.shape[1]}, weights expect D={d}")
    if not 1 <= k <= h:
        raise ValueError(f"need 1 <= k <= H (got k={k}, H={h})")


def _check_geometry(x: torch.Tensor, d: int, h: int, k: int) -> ctypes.CDLL:
    lib = _build.load_library()
    _check_rows(x, d, h, k)
    if d % 32 or d > lib.wst_max_d():
        raise ValueError(f"the SAE kernels take D a multiple of 32 and <= {lib.wst_max_d()} (got {d})")
    if h % 32 or h > lib.wst_max_row_width():
        raise ValueError(
            f"the SAE kernels take H a multiple of 32 and <= {lib.wst_max_row_width()} (got {h})"
        )
    return lib


def _check_wide_geometry(x: torch.Tensor, d: int, h: int, k: int, what: str) -> ctypes.CDLL:
    """The CTA-per-row routes' limits (kernel A's wide route, the blocked
    encode): D and H multiples of 32, H up to ``wst_max_wide_row_width()``."""
    lib = _build.load_library()
    _check_rows(x, d, h, k)
    if d % 32 or h % 32 or h > lib.wst_max_wide_row_width():
        raise ValueError(f"{what} takes D and H multiples of 32 and H <= "
                         f"{lib.wst_max_wide_row_width()} (got D={d}, H={h})")
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


def fixed_order_sum(v: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """The partials' sum in ``sae_loss_finalize_kernel``'s and
    ``coder_sum_kernel``'s order: thread t adds v[t], v[t + 256], ... in
    turn, then a halving tree over the 256 threads."""
    buf = torch.zeros(threads, dtype=torch.float32, device=v.device)
    for i in range(0, v.numel(), threads):
        part = v[i:i + threads]
        buf[:part.numel()] += part
    w = threads // 2
    while w:
        buf[:w] += buf[w:2 * w]
        w //= 2
    return buf[0]


def group_row_sq(resid: torch.Tensor, threads: int = 128, pairs: int = 4,
                 warp: int = 32) -> torch.Tensor:
    """Each row's sum of squares in the group form's order
    (``csrc/select_decode.cuh: group_select_decode``): thread t of the
    row's warp group squares its columns into its sum in turn (passes of
    ``threads * pairs`` column pairs, then its pairs p0 + t + i*threads,
    then the pair's two columns; each step an f32 fmaf, here the exact
    product and sum in f64 rounded once to f32), then a butterfly over
    each warp's lanes, then the warps in order.  -> [rows] f32."""
    rows, dout = resid.shape
    npairs = dout // 2
    r = resid.double()
    acc = torch.zeros(rows, threads, dtype=torch.float32, device=resid.device)
    t = torch.arange(threads, device=resid.device)
    for p0 in range(0, npairs, threads * pairs):
        for i in range(min(pairs, -(-(npairs - p0) // threads))):
            p = p0 + t + i * threads
            ok = p < npairs
            for j in (0, 1):
                v = r[:, (2 * p + j).clamp(max=dout - 1)]
                acc = torch.where(ok, (v * v + acc.double()).float(), acc)
    w = acc.view(rows, threads // warp, warp)
    lane = torch.arange(warp, device=resid.device)
    off = warp // 2
    while off:
        w = w + w[:, :, lane ^ off]
        off //= 2
    total = w[:, 0, 0]
    for i in range(1, threads // warp):
        total = total + w[:, i, 0]
    return total


def list_decode_plain(hid: torch.Tensor, pos: torch.Tensor, w_dec: torch.Tensor,
                      pass_cols: int | None = None) -> torch.Tensor:
    """Each row's decode from its selected rows of ``w_dec`` [H, dout]
    alone, written out as the select-and-decode kernels run it: the
    positive selections in feature order, each output column summed in
    list order from 0 (in ``pass_cols``-column passes, which change no
    value).  Products and sums are rounded apart, where the kernels fuse
    them.  -> [rows, dout] f32."""
    rows, h = hid.shape
    dout = w_dec.shape[1]
    dev = hid.device
    # each row's selections in feature order, padded with feature h: a zero row of W_dec
    nsel = int(pos.sum(dim=1).max()) if rows else 0
    feats = torch.where(pos, torch.arange(h, device=dev), h).sort(dim=1).values[:, :nsel]
    hv = torch.cat([hid.float(), torch.zeros(rows, 1, device=dev)], dim=1).gather(1, feats)
    wd = torch.cat([w_dec.float(), torch.zeros(1, dout, device=dev)])
    out = torch.empty(rows, dout, device=dev)
    step = pass_cols or dout
    for c0 in range(0, dout, step):
        cols = slice(c0, c0 + step)
        acc = torch.zeros(rows, min(step, dout - c0), device=dev)
        for j in range(nsel):
            acc = acc + hv[:, j:j + 1] * wd[feats[:, j], cols]
        out[:, cols] = acc
    return out


def fused_loss_wide_route_plain(x, row_offset, rows, we_t, b_enc, b_pre, wd_bf, b_out, k):
    """Kernel A's wide route at the group form's widths (H <=
    ``_build.MAX_GROUP_ROW``) written out in plain PyTorch, for the tests,
    on ``x[row_offset : row_offset + rows]``: the centred bf16 rows, pre =
    their f32 product with W_enc plus b_enc (the kPre GEMM; its chunks
    change no value), the group select (:func:`ops.topk.group_threshold`),
    the bf16 latent, the decode from the selected W_dec rows in feature
    order (:func:`list_decode_plain`), resid = (decode + b_out) - x, each
    row's sum of squares in the group form's order (:func:`group_row_sq`)
    and the finalize's fixed order over one partial a row.  Returns
    kernel A's (loss, l0, active, hid, resid, xc)."""
    xw = x[row_offset:row_offset + rows]
    xc = (xw.float() - b_pre).bfloat16()
    pre = mm_f32(xc, we_t.t()) + b_enc
    xi, th, _ = group_threshold(pre, k)
    hidden = torch.where(xi >= th, relu(pre), torch.zeros((), device=pre.device))
    hid = hidden.bfloat16()
    pos = hidden > 0
    resid = (list_decode_plain(hid, pos, wd_bf) + b_out) - xw.float()
    loss = fixed_order_sum(group_row_sq(resid)) / (rows * resid.shape[1])
    return loss, pos.sum().float() / rows, pos.any(dim=0), hid, resid, xc


def _fused_loss_launch(data, row_offset, rows, we_t, b_enc, b_pre, wd_bf, b_out, k, wide=False):
    """Kernel A on ``data[row_offset : row_offset + rows]`` (CUDA only): its
    warp form, or with ``wide`` its CTA-per-row route, which takes any D
    and H multiples of 32 up to ``wst_max_wide_row_width()``."""
    h, d = we_t.shape
    lib = (_check_wide_geometry(data, d, h, k, "kernel A's wide route") if wide
           else _check_geometry(data, d, h, k))
    if not 0 < rows or row_offset < 0 or row_offset + rows > data.shape[0]:
        raise ValueError(f"window [{row_offset}, {row_offset + rows}) outside {data.shape[0]} rows")
    dev = data.device
    bf, f32 = torch.bfloat16, torch.float32
    _check_operands(dev, w_enc_t=(we_t, bf, (h, d)), w_dec=(wd_bf, bf, (h, d)),
                    b_enc=(b_enc, f32, (h,)), b_pre=(b_pre, f32, (d,)), b_out=(b_out, f32, (d,)))
    if we_t.data_ptr() % 16:  # read by TMA
        raise ValueError("sae_fused_loss_fwd: w_enc_t must be 16-byte aligned")
    if wide and wd_bf.data_ptr() % 4:  # the group form reads bf16 pairs
        raise ValueError("sae_fused_loss_wide_fwd: w_dec must be 4-byte aligned")
    if wide:  # one loss partial a row; the encode's workspace holds one chunk
        partials, pre_rows = rows, min(rows, lib.wst_sae_topk_encode_chunk_rows(h))
        fwd, what = lib.wst_sae_fused_loss_wide_fwd, "sae_fused_loss_wide_fwd"
    else:  # one loss partial a CTA
        partials, pre_rows = -(-rows // lib.wst_rows_per_cta()), rows
        fwd, what = lib.wst_sae_fused_loss_fwd, "sae_fused_loss_fwd"
    hid = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)
    resid = torch.empty((rows, d), dtype=torch.float32, device=dev)
    xc = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((partials,), dtype=torch.float32, device=dev)
    pre = torch.empty((pre_rows, h), dtype=torch.float32, device=dev)  # the encode's workspace
    counts = torch.zeros((1 + h,), dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    l0 = torch.empty((), dtype=torch.float32, device=dev)
    err = fwd(
        data.data_ptr(), int(data.dtype == torch.bfloat16), row_offset, rows, d, h, k,
        we_t.data_ptr(), b_enc.data_ptr(), b_pre.data_ptr(), wd_bf.data_ptr(), b_out.data_ptr(),
        hid.data_ptr(), resid.data_ptr(), xc.data_ptr(), pre.data_ptr(), partial.data_ptr(),
        counts.data_ptr(), loss.data_ptr(), l0.data_ptr(), _stream(dev),
    )
    _build.check(err, what)
    return loss, l0, counts[1:] > 0, hid, resid, xc


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_offset, rows, w_enc, b_enc, b_pre, w_dec, b_dec, k, entry):
        we_t = _bf16_t(w_enc)
        wd_bf = w_dec.detach().to(torch.bfloat16)
        b_out = b_dec + b_pre
        if data.device.type == "cuda":
            wide = not row_kernels_hold(*w_enc.shape)
            loss, l0, active, hid, resid, xc = _fused_loss_launch(
                data, row_offset, rows, we_t, b_enc, b_pre, wd_bf, b_out, k, wide
            )
            entry.launches += 1
            entry.wide_launches += int(wide)
        elif data.device.type == "cpu":
            plain_calls[entry.__name__] += 1
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
    Kernel A's warp form where :func:`row_kernels_hold`, else its wide
    route.  Launches are counted in ``fused_sae_loss.launches``, those of
    the wide route also in ``fused_sae_loss.wide_launches``."""
    return _FusedLoss.apply(
        x, 0, x.shape[0], w_enc, b_enc, b_pre, w_dec, b_dec, k, fused_sae_loss
    )


def fused_sae_loss_indexed(data, step, w_enc, b_enc, b_pre, w_dec, b_dec, k, batch):
    """:func:`fused_sae_loss` over ``data[step*batch : (step+1)*batch]``,
    read by the kernel at a row offset into the epoch buffer (no slice is
    copied).  ``data`` is not differentiated.  Launches are counted in
    ``fused_sae_loss_indexed.launches`` (and ``.wide_launches``)."""
    return _FusedLoss.apply(
        data, int(step) * batch, batch, w_enc, b_enc, b_pre, w_dec, b_dec, k,
        fused_sae_loss_indexed,
    )


fused_sae_loss.launches = fused_sae_loss.wide_launches = 0
fused_sae_loss_indexed.launches = fused_sae_loss_indexed.wide_launches = 0


# ---------------------------------------------------------------------------
# kernel B and the blocked encode: the fused top-k encode
# ---------------------------------------------------------------------------


def topk_encode_plain(x, we_t, b_enc, b_pre, k, out_dtype):
    """Plain PyTorch version of kernel B and of the blocked encode."""
    xc = (x.float() - b_pre).bfloat16()
    pre = mm_f32(xc, we_t.t()) + b_enc
    return topk_mask_plain(pre, k).to(out_dtype)


def _encode_call(fwd, workspace_bytes, what: str, x, we_t, b_enc, b_pre, k, out_dtype):
    """One C call ``fwd`` of a top-k encode route (kernel B's or the
    blocked encode's) on CUDA rows: the operands checked, one workspace of
    ``workspace_bytes(rows, d, h)`` bytes, the latent [rows, H] in
    ``out_dtype``."""
    h, d = we_t.shape
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} writes bf16 or f32 (got {out_dtype})")
    dev = x.device
    _check_operands(dev, w_enc_t=(we_t, torch.bfloat16, (h, d)),
                    b_enc=(b_enc, torch.float32, (h,)), b_pre=(b_pre, torch.float32, (d,)))
    if we_t.data_ptr() % 16:  # read by TMA
        raise ValueError(f"{what}: w_enc_t must be 16-byte aligned")
    rows = x.shape[0]
    hidden = torch.empty((rows, h), dtype=out_dtype, device=dev)
    if rows:
        ws = torch.empty((workspace_bytes(rows, d, h),), dtype=torch.uint8, device=dev)
        err = fwd(x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d, h, k,
                  we_t.data_ptr(), b_enc.data_ptr(), b_pre.data_ptr(), hidden.data_ptr(),
                  int(out_dtype == torch.float32), ws.data_ptr(), _stream(dev))
        _build.check(err, what)
    return hidden


def _topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype):
    """Kernel B (CUDA only): per chunk of ``_build.topk_encode_chunk_rows(H)``
    rows the centre, the kPre GEMM and the warp select."""
    h, d = we_t.shape
    lib = _check_geometry(x, d, h, k)
    hidden = _encode_call(lib.wst_sae_topk_encode_fwd, lib.wst_sae_topk_encode_workspace_bytes,
                          "sae_topk_encode_fwd", x, we_t, b_enc, b_pre, k, out_dtype)
    if x.shape[0]:
        fused_topk_encode.launches += 1
    return hidden


def topk_encode_route_plain(x, we_t, b_enc, b_pre, k, out_dtype, chunk):
    """Kernel B's and the blocked encode's route written out in plain
    PyTorch, for the tests: per chunk of ``chunk`` rows the centred bf16
    rows, pre = their f32 product with W_enc plus b_enc (the kPre GEMM),
    the select's pass loop stopping at a count of exactly k
    (:func:`ops.topk.cta_threshold`; the warp select's midpoints and
    counts are the CTA select's), and the masked relu in ``out_dtype``."""
    out = torch.empty((x.shape[0], we_t.shape[0]), dtype=out_dtype, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        xc = (x[r0:r0 + chunk].float() - b_pre).bfloat16()
        pre = mm_f32(xc, we_t.t()) + b_enc
        xi, th, _ = cta_threshold(pre, k)
        out[r0:r0 + chunk] = torch.where(xi >= th, relu(pre),
                                         torch.zeros((), device=pre.device)).to(out_dtype)
    return out


def _blocked_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype):
    """The blocked encode (CUDA only), chunk by chunk through one workspace
    (a chunk's f32 pre and centred bf16 rows), allocated once a call."""
    h, d = we_t.shape
    lib = _check_wide_geometry(x, d, h, k, "the blocked encode")
    hidden = _encode_call(lib.wst_blocked_encode_fwd, lib.wst_blocked_workspace_bytes,
                          "blocked_encode_fwd", x, we_t, b_enc, b_pre, k, out_dtype)
    if x.shape[0]:
        fused_topk_encode.blocked_launches += 1
    return hidden


class _TopKEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_enc, b_enc, b_pre, k, out_dtype):
        we_t = _bf16_t(w_enc)
        blocked = uses_blocked(*w_enc.shape)
        if x.device.type == "cuda":
            launch = _blocked_encode_launch if blocked else _topk_encode_launch
            hidden = launch(x, we_t, b_enc, b_pre, k, out_dtype)
        elif x.device.type == "cpu":
            plain_calls["fused_topk_encode_blocked" if blocked else "fused_topk_encode"] += 1
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
    ``out_dtype``: kernel B where it holds the geometry, else the blocked
    encode.  Launches are counted in ``fused_topk_encode.launches`` (kernel
    B) and ``fused_topk_encode.blocked_launches``."""
    return _TopKEncode.apply(x, w_enc, b_enc, b_pre, k, out_dtype)


fused_topk_encode.launches = 0
fused_topk_encode.blocked_launches = 0
