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

Kernel B and the blocked encode are one C entry,
``sae_topk_encode_fwd`` (``csrc/blocked_encode.cu``): one chunk loop
with one select by row width, per chunk of rows the centre
(``sae_centre_kernel``), the encoder GEMM's kPre epilogue into an f32
workspace allocated here, and a select that writes the latent in bf16
or f32 (:func:`topk_encode_route_plain` writes the route out).  The
select's form is ``_build.select_form(h)``: kernel C's warp select up to
H = 3072, a warp group a row up to 8192 (``group_select_kernel``), a CTA
a row up to 40960 (``blocked_select_kernel``), past it the cluster form
(``cluster_select_kernel``: a thread-block cluster of 2, 4 or 8 CTAs a
row, ``_build.cluster_ctas``, each CTA a slice in registers and shared
memory, the counts summed over distributed shared memory, the last passes
on the compacted candidates); the library counts the selects it launches
by form (:func:`encode_select_launches`).
Its chunk is the rows whose f32 pre fits ``_build.PRE_BUDGET``
(:func:`_build.topk_encode_chunk_rows`: 27,264 at H = 3072), W_enc
streams once a chunk, and it takes H up to ``_build.MAX_BLOCKED_ROW`` =
2^20 (``pallas_sae.py:_MAX_H``).  The entry stands for two Pallas kernels,
and :func:`fused_topk_encode` counts its launches by the one the JAX
package would take (:func:`uses_blocked`, ``pallas_sae.py:1433-1434``):
kernel B, ``fused_topk_encode`` (``_encode_forward``, :77), wherever
bf16 W_enc fits its 48 MiB budget -- every Whisper SAE up to
whisper-tiny 128x (D = 384, H = 49152) but whisper-large 16x and wider
-- else the blocked encode, ``_encode_forward_blocked`` (:1392), the
branch for weights that do not fit on chip.  Kernel A's warp form
holds a row of pre in one warp's registers and keeps D/32 decode sums a
lane, so it takes D % 32 == 0, D <= 384 and H <= 3072
(:func:`row_kernels_hold`).  Kernel A also has a wide route,
``sae_fused_loss_wide_fwd``: the centre, then per chunk of kernel B's
rows the kPre encode and the select-and-decode, then the finalize over
one partial a row.  The select-and-decode is the
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
:func:`row_kernels_hold`, else through the wide route, up to H = 40960
(the CTA select-and-decode's row in registers); beyond that budget
(whisper-tiny 128x, whisper-large) the SAE loss is composed around the
top-k encode (``models/sae.py``), as the JAX package composes it
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
:490-517, ``_bwd`` :123-143).  On the CPU its products are dense f32
products of bf16 operands (``mm_f32``), the counterpart of
``preferred_element_type=f32``.  On the card the TopK SAE losses --
kernel A's (:class:`_FusedLoss`) and the composed one
(:func:`composed_sae_loss`, where kernel A does not hold) -- take their
dW_enc, db_enc and dW_dec from one C entry over the selected latents
alone, ``sae_topk_bwd`` (``csrc/sae_backward.cu``, which replaces no
Pallas kernel: XLA ran these products), with each route's bf16 rounding
points; only the order of f32 sums differs from the dense products.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.device import mm_f32
from . import _build
from .topk import (cluster_threshold, cta_threshold, group_threshold, plain_calls, relu,
                   topk_mask_plain)


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
    """The top-k encode's blocked branch, as the JAX package's
    ``pallas_sae.py:uses_blocked`` (:1433-1434): bf16 W_enc [D, H] past
    ``FUSED_W_BYTES``."""
    return d * h * 2 > FUSED_W_BYTES


def encode_select_launches() -> dict[str, int]:
    """The selects the top-k encode has launched in this process, by form (``_build.SELECT_FORMS``): one a chunk.  CUDA only:
    the count is the library's."""
    lib = _build.load_library()
    return {f: int(lib.wst_encode_select_launches(i)) for i, f in enumerate(_build.SELECT_FORMS)}


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


def _check_wide_geometry(x: torch.Tensor, d: int, h: int, k: int, what: str,
                         max_h: int) -> ctypes.CDLL:
    """The limits of the routes whose GEMM takes any width (kernel A's wide
    route, the top-k encode): D and H multiples of 32, H up to the route's
    ``max_h``."""
    lib = _build.load_library()
    _check_rows(x, d, h, k)
    if d % 32 or h % 32 or h > max_h:
        raise ValueError(f"{what} takes D and H multiples of 32 and H <= {max_h} "
                         f"(got D={d}, H={h})")
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
# the step's backward over the selected latents
# ---------------------------------------------------------------------------


def _dense_dpre(hid, d_recon, wd_bf, composed):
    """The dense gradient of the pre-activation [B, H] in f32, zero off the
    selection, as each route's backward has it: kernel A's the f32 product
    of the bf16 d_recon with W_dec; the composed route's the f32 product of
    the f32 d_recon with W_dec, rounded to bf16 (the latent's gradient)."""
    dhidden = mm_f32(d_recon, wd_bf.t())
    if composed:
        dhidden = dhidden.bfloat16().float()
    # bf16 rounding keeps the sign, so hid > 0 is the f32 selection
    return torch.where(hid > 0, dhidden, torch.zeros((), device=dhidden.device))


def _dense_topk_backward(hid, d_recon, xc, wd_bf, composed):
    """(dw_enc [D, H], db_enc [H], dw_dec [H, D]) as dense f32 products of
    bf16 operands, the JAX custom VJPs' products (``_bwd`` :123-143,
    ``_fused_loss_vjp_bwd`` :321-353): each route's CPU backward, and the
    yardstick of :func:`sae_topk_backward`."""
    dpre = _dense_dpre(hid, d_recon, wd_bf, composed)
    dw_enc = mm_f32(xc.t(), dpre.bfloat16())
    db_enc = dpre.sum(dim=0)  # f32 sums: a bf16 reduction loses ~1e-3
    dw_dec = mm_f32(hid.t(), d_recon)
    if composed:  # W_dec enters the decode as bf16
        dw_dec = dw_dec.bfloat16().float()
    return dw_enc, db_enc, dw_dec


def sae_topk_backward_plain(hid, d_recon, xc, wd_bf, composed):
    """Plain PyTorch version of ``wst_sae_topk_bwd`` (``csrc/sae_backward.cu``):
    the positive entries of the latent ``hid`` [B, H] compacted row by row,
    each entry's dot of its row of ``d_recon`` [B, D] with its row of
    ``wd_bf`` [H, D] (f32 sums of exactly widened operands), then the
    entries in feature-major order, rows ascending within a feature, and
    the per-feature sums in that order.  Rounding points by route, as the
    kernel's template: dpre rounded to bf16 before the dW_enc product;
    ``composed`` also sums the rounded dpre into db_enc and rounds dW_dec
    to bf16 after its sum.  -> (dw_enc [D, H], db_enc [H], dw_dec [H, D])
    in f32."""
    h, d = wd_bf.shape
    dev = hid.device
    b, f = (hid > 0).nonzero(as_tuple=True)  # row-major: the rows' lists in turn
    drec = d_recon.float()
    dots = (drec[b] * wd_bf[f].float()).sum(dim=1)
    p_enc = dots.bfloat16().float()
    p_db = p_enc if composed else dots
    order = torch.sort(f, stable=True).indices  # feature-major, rows ascending
    b, f, p_enc, p_db = b[order], f[order], p_enc[order], p_db[order]
    hv = hid[b, f].float()
    dw_dec = torch.zeros(h, d, device=dev).index_add_(0, f, hv[:, None] * drec[b])
    dw_enc_t = torch.zeros(h, d, device=dev).index_add_(0, f, xc[b].float() * p_enc[:, None])
    db_enc = torch.zeros(h, device=dev).index_add_(0, f, p_db)
    if composed:
        dw_dec = dw_dec.bfloat16().float()
    return dw_enc_t.t().contiguous(), db_enc, dw_dec


def sae_topk_backward(hid, d_recon, xc, wd_bf, composed):
    """The TopK SAE step's backward over the selected latents, in one C
    entry (``wst_sae_topk_bwd``): from the bf16 latent ``hid`` [B, H],
    ``d_recon`` [B, D] (f32 on the composed route, else bf16), the centred
    bf16 rows ``xc`` [B, D] and bf16 ``wd_bf`` [H, D], the f32 (dw_enc [D,
    H], db_enc [H], dw_dec [H, D]) with the rounding points of kernel A's
    route or, with ``composed``, of the composed route.  Launches are
    counted in ``sae_topk_backward.launches``, the composed route's also
    in ``.composed_launches``; a CPU tensor takes
    :func:`sae_topk_backward_plain`."""
    if hid.device.type == "cpu":
        plain_calls["sae_topk_backward"] += 1
        return sae_topk_backward_plain(hid, d_recon, xc, wd_bf, composed)
    if hid.device.type != "cuda":
        raise ValueError(f"sae_topk_backward: unsupported device {hid.device}")
    rows, h = hid.shape
    d = wd_bf.shape[1]
    lib = _build.load_library()
    max_d = lib.wst_sae_topk_bwd_max_d()
    if d % 32 or h % 32 or d > max_d:
        raise ValueError(f"sae_topk_backward takes D and H multiples of 32 and D <= {max_d} "
                         f"(got D={d}, H={h})")
    dev = hid.device
    bf, f32 = torch.bfloat16, torch.float32
    operands = dict(hid=(hid, bf, (rows, h)), d_recon=(d_recon, f32 if composed else bf, (rows, d)),
                    xc=(xc, bf, (rows, d)), w_dec=(wd_bf, bf, (h, d)))
    _check_operands(dev, **operands)
    for name, (t, _, _) in operands.items():
        if t.data_ptr() % 16:  # read in 8- and 16-byte runs
            raise ValueError(f"sae_topk_backward: {name} must be 16-byte aligned")
    dw_enc = torch.empty((d, h), dtype=f32, device=dev)
    db_enc = torch.empty((h,), dtype=f32, device=dev)
    dw_dec = torch.empty((h, d), dtype=f32, device=dev)
    ws = torch.empty((lib.wst_sae_topk_bwd_workspace_bytes(rows, d, h),), dtype=torch.uint8,
                     device=dev)
    err = lib.wst_sae_topk_bwd(
        int(composed), hid.data_ptr(), d_recon.data_ptr(), xc.data_ptr(), wd_bf.data_ptr(),
        rows, d, h, dw_enc.data_ptr(), db_enc.data_ptr(), dw_dec.data_ptr(), ws.data_ptr(),
        _stream(dev))
    _build.check(err, "sae_topk_bwd")
    sae_topk_backward.launches += 1
    sae_topk_backward.composed_launches += int(composed)
    return dw_enc, db_enc, dw_dec


sae_topk_backward.launches = sae_topk_backward.composed_launches = 0


def _backward_products(hid, d_recon, xc, wd_bf, composed):
    """A route's (dw_enc, db_enc, dw_dec): the sparse entry on the card,
    the dense products (:func:`_dense_topk_backward`) on the CPU."""
    if hid.device.type == "cuda":
        return sae_topk_backward(hid, d_recon, xc, wd_bf, composed)
    return _dense_topk_backward(hid, d_recon, xc, wd_bf, composed)


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
    warp form, or with ``wide`` its wide route, which takes any D and H
    multiples of 32 up to ``_build.MAX_WIDE_ROW``."""
    h, d = we_t.shape
    lib = (_check_wide_geometry(data, d, h, k, "kernel A's wide route", _build.MAX_WIDE_ROW)
           if wide else _check_geometry(data, d, h, k))
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
        dw_enc, db_enc, dw_dec = _backward_products(hid, drec_bf, xc, wd_bf, composed=False)
        db_dec = d_recon.sum(dim=0)
        # b_pre enters twice: +recon and -encode input
        db_pre = db_dec - mm_f32(db_enc[None], we_t)[0]
        dx = None
        if ctx.needs_input_grad[0]:  # the rows' gradient keeps the dense product
            row_offset, rows, n, dtype = ctx.window
            dpre_bf = _dense_dpre(hid, drec_bf, wd_bf, composed=False).bfloat16()
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


def _topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype):
    """The top-k encode (CUDA only, uncounted): per chunk of
    ``_build.topk_encode_chunk_rows(H)`` rows, through one workspace
    allocated once a call, the centre, the kPre GEMM and the select of
    ``_build.select_form(H)``; the latent [rows, H] in ``out_dtype``."""
    h, d = we_t.shape
    lib = _check_wide_geometry(x, d, h, k, "the top-k encode", _build.MAX_BLOCKED_ROW)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the top-k encode writes bf16 or f32 (got {out_dtype})")
    dev = x.device
    _check_operands(dev, w_enc_t=(we_t, torch.bfloat16, (h, d)),
                    b_enc=(b_enc, torch.float32, (h,)), b_pre=(b_pre, torch.float32, (d,)))
    if we_t.data_ptr() % 16:  # read by TMA
        raise ValueError("sae_topk_encode_fwd: w_enc_t must be 16-byte aligned")
    rows = x.shape[0]
    hidden = torch.empty((rows, h), dtype=out_dtype, device=dev)
    if rows:
        ws = torch.empty((lib.wst_sae_topk_encode_workspace_bytes(rows, d, h),),
                         dtype=torch.uint8, device=dev)
        err = lib.wst_sae_topk_encode_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d, h, k, we_t.data_ptr(),
            b_enc.data_ptr(), b_pre.data_ptr(), hidden.data_ptr(),
            int(out_dtype == torch.float32), ws.data_ptr(), _stream(dev))
        _build.check(err, "sae_topk_encode_fwd")
    return hidden


def topk_encode_route_plain(x, we_t, b_enc, b_pre, k, out_dtype, chunk=None):
    """The top-k encode's route written out in plain PyTorch, for the
    tests: per chunk of ``chunk`` rows (by default the route's own,
    :func:`_build.topk_encode_chunk_rows`) the centred bf16 rows, pre =
    their f32 product with W_enc plus b_enc (the kPre GEMM), the select's
    pass loop stopping at a count of exactly k in the form of the row width
    (:func:`ops.topk.group_threshold` for the group form,
    :func:`ops.topk.cluster_threshold` for the cluster form, else
    :func:`ops.topk.cta_threshold`: the warp and CTA forms' midpoints and
    counts are the CTA select's, and the other two keep them), and the
    masked relu in ``out_dtype``."""
    h = we_t.shape[0]
    if chunk is None:
        chunk = _build.topk_encode_chunk_rows(h)
    threshold = {"group": group_threshold, "cluster": cluster_threshold}.get(
        _build.select_form(h), cta_threshold)
    out = torch.empty((x.shape[0], h), dtype=out_dtype, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        xc = (x[r0:r0 + chunk].float() - b_pre).bfloat16()
        pre = mm_f32(xc, we_t.t()) + b_enc
        xi, th, _ = threshold(pre, k)
        out[r0:r0 + chunk] = torch.where(xi >= th, relu(pre),
                                         torch.zeros((), device=pre.device)).to(out_dtype)
    return out


def _topk_encode_counted(x, we_t, b_enc, b_pre, k, out_dtype):
    """The top-k encode's latent in ``out_dtype``: the C entry on the card,
    counted as kernel B or as the blocked encode (:func:`uses_blocked`),
    else the plain version, counted in ``plain_calls``."""
    blocked = uses_blocked(*we_t.shape[::-1])
    if x.device.type == "cuda":
        hidden = _topk_encode_launch(x, we_t, b_enc, b_pre, k, out_dtype)
        if x.shape[0] and blocked:
            fused_topk_encode.blocked_launches += 1
        elif x.shape[0]:
            fused_topk_encode.launches += 1
        return hidden
    if x.device.type == "cpu":
        plain_calls["fused_topk_encode_blocked" if blocked else "fused_topk_encode"] += 1
        return topk_encode_plain(x, we_t, b_enc, b_pre, k, out_dtype)
    raise ValueError(f"fused top-k encode: unsupported device {x.device}")


class _TopKEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_enc, b_enc, b_pre, k, out_dtype):
        we_t = _bf16_t(w_enc)
        hidden = _topk_encode_counted(x, we_t, b_enc, b_pre, k, out_dtype)
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
    ``out_dtype``: one C entry, counted as kernel B where bf16 W_enc fits
    the JAX package's budget, else as the blocked encode
    (:func:`uses_blocked`).  Launches are counted in
    ``fused_topk_encode.launches`` (kernel B) and
    ``fused_topk_encode.blocked_launches``, the selects by form in the
    library (:func:`encode_select_launches`)."""
    return _TopKEncode.apply(x, w_enc, b_enc, b_pre, k, out_dtype)


fused_topk_encode.launches = 0
fused_topk_encode.blocked_launches = 0


# ---------------------------------------------------------------------------
# the composed loss: the top-k encode, the dense decode, the sparse backward
# ---------------------------------------------------------------------------


class _ComposedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_enc, b_enc, b_pre, w_dec, b_dec, k):
        we_t = _bf16_t(w_enc)
        hidden = _topk_encode_counted(x, we_t, b_enc, b_pre, k, torch.bfloat16)
        wd_bf = w_dec.detach().to(torch.bfloat16)
        recon = mm_f32(hidden, wd_bf) + b_dec + b_pre
        resid = recon - x
        loss = torch.mean(torch.square(resid))
        pos = hidden > 0
        l0 = pos.sum(dim=-1).float().mean()
        active = pos.any(dim=0)
        ctx.save_for_backward(x, b_pre, hidden, resid, we_t, wd_bf)
        ctx.mark_non_differentiable(l0, active)
        return loss, l0, active

    @staticmethod
    def backward(ctx, g_loss, _g_l0, _g_active):
        x, b_pre, hid, resid, we_t, wd_bf = ctx.saved_tensors
        # the mean's and the square's gradients as autograd forms them
        d_recon = (g_loss / resid.numel()) * (2.0 * resid)
        xc = (x.float() - b_pre).bfloat16()
        dw_enc, db_enc, dw_dec = _backward_products(hid, d_recon, xc, wd_bf, composed=True)
        db_dec = d_recon.sum(dim=0)
        # b_pre enters twice: +recon and -encode input
        db_pre = db_dec - mm_f32(db_enc[None], we_t)[0]
        dx = None
        if ctx.needs_input_grad[0]:  # the rows' gradient keeps the dense product
            dpre_bf = _dense_dpre(hid, d_recon, wd_bf, composed=True).bfloat16()
            dx = mm_f32(dpre_bf, we_t).to(x.dtype) + (-d_recon).to(x.dtype)
        return dx, dw_enc, db_enc, db_pre, dw_dec, db_dec, None


def composed_sae_loss(x, w_enc, b_enc, b_pre, w_dec, b_dec, k):
    """(loss, l0, active) of a TopK SAE under AMP where kernel A does not
    hold (whisper-tiny 128x, whisper-large): the forward of
    ``models/sae.py:topk_sae_apply`` in bf16 -- the top-k encode, the
    decode as the f32 product of the bf16 latent with bf16 W_dec, the
    residual and the mean -- under one autograd function, whose backward
    replaces autograd's dense products: on the card the sparse entry
    (:func:`sae_topk_backward`, the composed route's rounding points), on
    the CPU the same dense products.  The encode counts as
    :func:`fused_topk_encode` does."""
    return _ComposedLoss.apply(x, w_enc, b_enc, b_pre, w_dec, b_dec, k)
