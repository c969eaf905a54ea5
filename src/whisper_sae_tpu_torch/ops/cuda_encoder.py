"""The fused Whisper-encoder kernels on the card (``csrc/encoder_kernels.cu``,
``csrc/encoder_gemm.cu``, ``csrc/attention_kernel.cu``).

Each wrapper checks what its kernel takes, allocates the outputs,
launches on the current stream and counts the launch in its own
``launches``; a shape the kernel cannot take raises.  The weights are
given in the JAX package's ``x @ W`` layout; the kernels take them in an
``[N, K]`` bf16 layout with f32 biases and LN vectors.  That layout is
built once per parameter tensor (``prepared``, keyed on the source
tensors' address, shape, strides, dtype and version, so an in-place
update rebuilds it, and dropped when the source tensors are freed), not
on every launch.

- ``conv_stem_fwd`` replaces ``ops/pallas_encoder.py:fused_conv_stem``
  (``pallas_call`` at :604) at every width the fused route takes (D a
  multiple of 128 up to 1536), in one C call of three launches:
  ``stem_prep_kernel`` (the mel time-major with conv1's zero rows, and
  the hidden's zero row), conv1 as three tap products on the Hopper GEMM
  of ``csrc/encoder_gemm.cu`` with the GELU epilogue into a bf16 hidden
  in device memory, and conv2 as three stride-2 tap products on the same
  GEMM with the GELU and positions epilogue.
- ``attention_block_fwd`` replaces ``fused_attention_block`` (:340) with
  three steps: ``ln_qkv_fwd`` (LN1 of the rows into a bf16 scratch, then
  one ``[rows, D] x [D, 3D]`` product on the Hopper GEMM of
  ``csrc/encoder_gemm.cu``: a producer warp feeding TMA tiles to two
  wgmma consumer warpgroups, a persistent grid, the q/k/v epilogue on the
  accumulators), ``self_attention_fwd`` (the Hopper attention core of
  ``csrc/attention_kernel.cu``: three consumer warpgroups of 64 queries,
  wgmma products, K/V tiles fed by TMA) and ``out_proj_fwd`` (the same
  GEMM with the bias and residual epilogue).  The product over all heads
  and the per-head core want different tilings; q, k, v and the core's
  output make one bf16 round trip through device memory each, and LN1's
  rows one more.
- ``flash_self_attention_fwd`` is the same core launched from the
  composed route, where the JAX package calls the library flash
  attention (``models/whisper.py:_flash_self_attention``, :141).
- ``mlp_block_fwd`` replaces ``fused_mlp_block`` (:500) at every width the
  fused route takes (D and F multiples of 128, D <= 1536), in one C call
  of four launches: LN2 of the rows, fc1 on the Hopper GEMM with the GELU
  epilogue into a bf16 ``[rows, F]`` hidden in device memory, fc2 on the
  same GEMM with the residual epilogue (and the ``mlp_out`` capture), and
  the final-LN capture.

Bounds at whisper-tiny, 64 clips: operations (see the sources' notes).
"""

from __future__ import annotations

import weakref

import torch

from . import _build

_BF = torch.bfloat16
_EPI_QKV, _EPI_RESIDUAL = 0, 1  # epilogues of wst_enc_gemm_fwd (csrc/encoder_gemm.cuh)
_GEMM_WIDTH = 128  # the GEMM's N and K are multiples of its tile (the fused route's gate too)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _bf16_nk(w: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` (``x @ W``) -> contiguous bf16 ``[N, K]``."""
    return w.detach().t().to(_BF).contiguous()


def _f32(b: torch.Tensor) -> torch.Tensor:
    return b.detach().to(torch.float32).contiguous()


def _check_rows(x: torch.Tensor, what: str, dims: int) -> None:
    if x.device.type != "cuda" or x.dtype != _BF or x.dim() != dims or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {dims}-D bfloat16 CUDA tensor "
                         f"(got {x.dtype} {tuple(x.shape)} on {x.device})")


def _check_width(d: int, what: str) -> None:
    if d % _GEMM_WIDTH:
        raise ValueError(f"{what} takes D a multiple of {_GEMM_WIDTH} (got {d})")


# ---------------------------------------------------------------------------
# the kernels' weight layouts, built once per parameter tensor
# ---------------------------------------------------------------------------

_prepared: dict = {}


def _owner(t: torch.Tensor) -> torch.Tensor:
    """The tensor that owns ``t``'s memory: its base if it is a view."""
    return t if t._base is None else t._base


def prepared(kind: str, sources: tuple, build):
    """``build(*sources)``, cached per source tensors.

    The key is ``kind`` and each source's address, shape, strides, dtype
    and device; the entry keeps the sources' versions, so an in-place
    update rebuilds it.  The entry goes when any source's owner (its base,
    for the views ``_layer`` makes) is freed, before its memory can be
    reused by other tensors that would hit a stale entry; the cache holds
    no reference to the sources, so it keeps nothing alive past the
    weights themselves (an output that shares a source's memory is copied).
    Inference tensors keep no version counter: they are built every call."""
    if any(s.is_inference() for s in sources):
        return build(*sources)
    key = (kind,) + tuple((s.data_ptr(), tuple(s.shape), s.stride(), s.dtype, s.device)
                          for s in sources)
    versions = tuple(s._version for s in sources)
    entry = _prepared.get(key)
    if entry is not None and entry[0] == versions:
        return entry[1]
    mem = {s.untyped_storage().data_ptr() for s in sources}
    out = tuple(o.clone() if o.untyped_storage().data_ptr() in mem else o
                for o in build(*sources))
    if entry is None:  # a rebuild keeps the finalizers of the first build
        for owner in {id(o): o for o in map(_owner, sources)}.values():
            weakref.finalize(owner, _prepared.pop, key, None).atexit = False
    _prepared[key] = (versions, out)
    return out


def _build_qkv(wq, wk, wv, bq, bv, ln_g, ln_b):
    d = wq.shape[0]
    wt = torch.cat([_bf16_nk(wq), _bf16_nk(wk), _bf16_nk(wv)])
    bias = torch.cat([_f32(bq), torch.zeros(d, dtype=torch.float32, device=bq.device), _f32(bv)])
    return wt, bias, _f32(ln_g), _f32(ln_b)


def qkv_weights(p: dict, ln_g, ln_b):
    """(wt ``[3D, D]`` bf16 = Wq^T, Wk^T, Wv^T stacked; bias ``[3D]`` f32 =
    (bq, 0, bv); LN1 gain and shift in f32) for ``ln_qkv_fwd``."""
    return prepared("qkv", (p["wq"], p["wk"], p["wv"], p["bq"], p["bv"], ln_g, ln_b), _build_qkv)


def _build_out_proj(wo, bo):
    return _bf16_nk(wo), _f32(bo)


def out_proj_weights(wo, bo):
    """(Wo^T ``[D, D]`` bf16, bo f32) for ``out_proj_fwd``."""
    return prepared("out_proj", (wo, bo), _build_out_proj)


def _build_mlp(w1, b1, w2, b2, ln_g, ln_b):
    return _bf16_nk(w1), _f32(b1), _bf16_nk(w2), _f32(b2), _f32(ln_g), _f32(ln_b)


def mlp_weights(p: dict, ln_g, ln_b):
    """(W1^T ``[F, D]`` bf16, b1 f32, W2^T ``[D, F]`` bf16, b2 f32, LN2 gain
    and shift f32) for ``mlp_block_fwd``."""
    return prepared("mlp", (p["w1"], p["b1"], p["w2"], p["b2"], ln_g, ln_b), _build_mlp)


def _build_stem(conv1_w, conv1_b, conv2_w, conv2_b, pos):
    d, n_mels, _ = conv1_w.shape
    w1t = conv1_w.detach().to(_BF).permute(0, 2, 1).reshape(d, 3 * n_mels).contiguous()
    w2t = conv2_w.detach().to(_BF).permute(0, 2, 1).reshape(d, 3 * d).contiguous()
    return w1t, _f32(conv1_b), w2t, _f32(conv2_b), pos.detach().to(_BF).contiguous()


def stem_weights(conv1_w, conv1_b, conv2_w, conv2_b, pos):
    """(conv1 ``[D, 3 n_mels]`` and conv2 ``[D, 3D]`` bf16 with tap j in
    columns j*n_mels.. / j*D.., their biases f32, ``pos`` bf16) for
    ``conv_stem_fwd``; ``pos`` is the rows the launch reads."""
    return prepared("stem", (conv1_w, conv1_b, conv2_w, conv2_b, pos), _build_stem)


def conv_stem_fwd(mel, conv1_w, conv1_b, conv2_w, conv2_b, pos) -> torch.Tensor:
    """mel ``[B, n_mels, T_mel]`` bf16 -> ``[B, T_mel//2, D]`` bf16, D a
    multiple of 128 up to ``wst_enc_wide_max()``: one C call of three
    launches (the prep, conv1, conv2) with two bf16 scratch tensors, the
    padded time-major mel ``[B, T_mel + 2, n_mels]`` and the padded hidden
    ``[B, T_mel + 1, D]``."""
    mel = mel.contiguous()  # the prep reads [B, n_mels, T_mel] rows
    _check_rows(mel, "conv_stem_fwd", 3)
    b, n_mels, t_mel = mel.shape
    d = conv1_w.shape[0]
    _check_width(d, "conv_stem_fwd")
    lib = _build.load_library()
    if d > lib.wst_enc_wide_max():
        raise ValueError(f"conv_stem_fwd takes D <= {lib.wst_enc_wide_max()} (got {d})")
    if t_mel % 2 or n_mels % 16 or tuple(conv1_w.shape) != (d, n_mels, 3):
        raise ValueError(f"conv_stem_fwd takes an even T_mel and n_mels a multiple of 16 "
                         f"(got {n_mels} x {t_mel}, conv1 {tuple(conv1_w.shape)})")
    t = t_mel // 2
    if pos.shape[0] < t:
        raise ValueError(f"{pos.shape[0]} positions for {t} frames")
    w1t, b1, w2t, b2, posb = stem_weights(conv1_w, conv1_b, conv2_w, conv2_b, pos[:t])
    mel_pad = torch.empty((b, t_mel + 2, n_mels), dtype=_BF, device=mel.device)
    h_pad = torch.empty((b, t_mel + 1, d), dtype=_BF, device=mel.device)
    out = torch.empty((b, t, d), dtype=_BF, device=mel.device)
    err = lib.wst_conv_stem_fwd(mel.data_ptr(), b, t_mel, n_mels, d, w1t.data_ptr(),
                                b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), posb.data_ptr(),
                                mel_pad.data_ptr(), h_pad.data_ptr(), out.data_ptr(),
                                _stream(mel.device))
    _build.check(err, "conv_stem_fwd")
    conv_stem_fwd.launches += 1
    return out


def ln_qkv_fwd(x, ln_g, ln_b, p, n_heads: int):
    """LN1 + q/k/v on rows ``[N, D]`` bf16 -> (q scaled, k, v), each ``[N, D]``:
    the rows' LN into a bf16 scratch, then the Hopper GEMM with the q/k/v
    epilogue (D a multiple of 128 up to ``wst_enc_wide_max()``)."""
    _check_rows(x, "ln_qkv_fwd", 2)
    n, d = x.shape
    _check_width(d, "ln_qkv_fwd")
    wt, bias, g, bln = qkv_weights(p, ln_g, ln_b)
    if tuple(wt.shape) != (3 * d, d):
        raise ValueError(f"ln_qkv_fwd: q/k/v weights {tuple(p['wq'].shape)} for D={d}")
    lib = _build.load_library()
    if d > lib.wst_enc_wide_max():
        raise ValueError(f"ln_qkv_fwd takes D <= {lib.wst_enc_wide_max()} (got {d})")
    xln = torch.empty_like(x)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    stream = _stream(x.device)
    err = lib.wst_ln_rows_fwd(x.data_ptr(), n, d, g.data_ptr(), bln.data_ptr(), xln.data_ptr(),
                              stream)
    _build.check(err, "ln_qkv_fwd (LN1)")
    err = lib.wst_enc_gemm_fwd(_EPI_QKV, xln.data_ptr(), wt.data_ptr(), n, 3 * d, d,
                               bias.data_ptr(), float(d // n_heads) ** -0.5, d, q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), None, stream)
    _build.check(err, "ln_qkv_fwd")
    ln_qkv_fwd.launches += 1
    return q, k, v


def _attention_launch(q, k, v, n_heads: int, t_real: int | None, what: str) -> torch.Tensor:
    for t in (q, k, v):
        _check_rows(t, what, 3)
    b, t, d = q.shape
    lib = _build.load_library()
    if d % n_heads or d // n_heads != lib.wst_enc_head_dim():
        raise ValueError(f"{what} takes a head dim of {lib.wst_enc_head_dim()} "
                         f"(got D={d}, {n_heads} heads)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one shape (self-attention)")
    t_real = t if t_real is None else int(t_real)
    if not 1 <= t_real <= t:
        raise ValueError(f"{what}: need 1 <= t_real <= T (got {t_real}, T={t})")
    out = torch.empty_like(q)
    err = lib.wst_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, t, t_real, d,
                                n_heads, out.data_ptr(), _stream(q.device))
    _build.check(err, what)
    return out


def self_attention_fwd(q, k, v, n_heads: int, t_real: int | None = None) -> torch.Tensor:
    """softmax(q k^T) v per head on ``[B, T, D]`` bf16 (heads in column
    blocks of 64, q already scaled); key columns >= ``t_real`` masked."""
    out = _attention_launch(q, k, v, n_heads, t_real, "self_attention_fwd")
    self_attention_fwd.launches += 1
    return out


def flash_self_attention_fwd(q, k, v, n_heads: int) -> torch.Tensor:
    """The same core, launched from the composed route (row 11)."""
    out = _attention_launch(q, k, v, n_heads, None, "flash_self_attention_fwd")
    flash_self_attention_fwd.launches += 1
    return out


def out_proj_fwd(attn, x, wo, bo) -> torch.Tensor:
    """x + bf16(attn Wo + bo) on rows ``[N, D]`` bf16: the Hopper GEMM with
    the bias and residual epilogue (D a multiple of 128)."""
    _check_rows(attn, "out_proj_fwd", 2)
    _check_rows(x, "out_proj_fwd", 2)
    n, d = x.shape
    _check_width(d, "out_proj_fwd")
    if attn.shape != x.shape:
        raise ValueError("out_proj_fwd: attn and x must share one shape")
    wt, bias = out_proj_weights(wo, bo)
    if tuple(wt.shape) != (d, d):
        raise ValueError(f"out_proj_fwd: Wo {tuple(wo.shape)} for D={d}")
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.wst_enc_gemm_fwd(_EPI_RESIDUAL, attn.data_ptr(), wt.data_ptr(), n, d, d,
                               bias.data_ptr(), 1.0, d, out.data_ptr(), None, None, x.data_ptr(),
                               _stream(x.device))
    _build.check(err, "out_proj_fwd")
    out_proj_fwd.launches += 1
    return out


def attention_block_fwd(x, ln_g, ln_b, p, n_heads: int, t_real: int | None = None):
    """x + out_proj(MHA(LN1(x))) on ``[B, T, D]`` bf16: three launches."""
    _check_rows(x, "attention_block_fwd", 3)
    b, t, d = x.shape
    rows = x.view(b * t, d)
    q, k, v = ln_qkv_fwd(rows, ln_g, ln_b, p, n_heads)
    attn = self_attention_fwd(q.view(b, t, d), k.view(b, t, d), v.view(b, t, d), n_heads, t_real)
    return out_proj_fwd(attn.view(b * t, d), rows, p["wo"], p["bo"]).view(b, t, d)


def _mlp_outputs(x, capture: bool, final_ln, capture_dtype):
    """(out, cap, fg, fb, cap_mode, mlp_in, mlp_out) for the launch."""
    if final_ln is not None and capture_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mlp_block captures in bf16 or f32 (got {capture_dtype})")
    n, d = x.shape
    out = torch.empty_like(x)
    cap = fg = fb = mlp_in = mlp_out = None
    cap_mode = 0
    if final_ln is not None:
        fg, fb = _f32(final_ln[0]), _f32(final_ln[1])
        cap = torch.empty((n, d), dtype=capture_dtype, device=x.device)
        cap_mode = 2 if capture_dtype == torch.float32 else 1
    if capture:
        mlp_in, mlp_out = torch.empty_like(x), torch.empty_like(x)
    return out, cap, fg, fb, cap_mode, mlp_in, mlp_out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _mlp_result(out, cap, mlp_in, mlp_out, capture: bool):
    outs = [out] + ([cap] if cap is not None else []) + ([mlp_in, mlp_out] if capture else [])
    return tuple(outs) if len(outs) > 1 else out


def mlp_block_fwd(x, ln_g, ln_b, p, capture: bool = False, final_ln=None,
                  capture_dtype=torch.bfloat16):
    """x + bf16(GELU(LN2(x) W1 + b1) W2 + b2) on rows ``[N, D]`` bf16, D and
    F multiples of 128, D up to ``wst_enc_wide_max()``.  Returns out [,
    ln_f(out) at ``capture_dtype``] [, mlp_in, mlp_out].  One C call: LN2
    (into ``mlp_in`` when captured, else a scratch), fc1 with GELU into a
    bf16 ``[N, F]`` scratch, fc2 with the residual, the final-LN capture."""
    _check_rows(x, "mlp_block_fwd", 2)
    n, d = x.shape
    f = p["w1"].shape[1]
    if d % _GEMM_WIDTH or f % _GEMM_WIDTH:
        raise ValueError(f"mlp_block_fwd takes D and F a multiple of {_GEMM_WIDTH} "
                         f"(got D={d}, F={f})")
    lib = _build.load_library()
    if d > lib.wst_enc_wide_max():
        raise ValueError(f"mlp_block_fwd takes D <= {lib.wst_enc_wide_max()} (got {d})")
    w1t, b1, w2t, b2, g, bln = mlp_weights(p, ln_g, ln_b)
    if tuple(w1t.shape) != (f, d) or tuple(w2t.shape) != (d, f):
        raise ValueError(f"mlp_block_fwd: weights {tuple(p['w1'].shape)}, "
                         f"{tuple(p['w2'].shape)} for D={d}")
    out, cap, fg, fb, cap_mode, mlp_in, mlp_out = _mlp_outputs(x, capture, final_ln,
                                                               capture_dtype)
    xln = mlp_in if capture else torch.empty_like(x)
    hid = torch.empty((n, f), dtype=_BF, device=x.device)
    err = lib.wst_mlp_block_fwd(x.data_ptr(), n, d, f, g.data_ptr(), bln.data_ptr(),
                                w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                                _ptr(fg), _ptr(fb), cap_mode, out.data_ptr(), _ptr(cap),
                                xln.data_ptr(), hid.data_ptr(), _ptr(mlp_out), _stream(x.device))
    _build.check(err, "mlp_block_fwd")
    mlp_block_fwd.launches += 1
    return _mlp_result(out, cap, mlp_in, mlp_out, capture)


for _fn in (conv_stem_fwd, ln_qkv_fwd, self_attention_fwd, flash_self_attention_fwd,
            out_proj_fwd, mlp_block_fwd):
    _fn.launches = 0
