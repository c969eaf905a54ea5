"""The fused Whisper-encoder kernels on the card (``csrc/encoder_kernels.cu``).

Each wrapper checks what its kernel takes, allocates the outputs,
launches on the current stream and counts the launch in its own
``launches``; a shape the kernel cannot take raises.  The weights are
given in the JAX package's ``x @ W`` layout and turned here into the
kernels' ``[N, K]`` bf16 layout (the B operand of ``mma.sync`` as two
32-bit loads).

- ``conv_stem_fwd`` replaces ``ops/pallas_encoder.py:fused_conv_stem``
  (``pallas_call`` at :604): 64 output frames a CTA up to D=512, and its
  wide form, 32 frames a CTA, for 512 < D <= 1536.  The even/odd split of
  the mel's time columns stays a torch copy before the launch, as it is
  XLA prep there.
- ``attention_block_fwd`` replaces ``fused_attention_block`` (:340) with
  three launches: ``ln_qkv_fwd`` (LN1 and one ``[rows, D] x [D, 3D]``
  product), ``self_attention_fwd`` (the Hopper attention core of
  ``csrc/attention_kernel.cu``: three consumer warpgroups of 64 queries,
  wgmma products, K/V tiles fed by TMA) and ``out_proj_fwd`` (the product
  with the bias and the residual).  Three launches instead of one because
  the product over all heads (out-projection) and the per-head core want
  different tilings; q, k, v and the core's output make one bf16 round
  trip through device memory each.
- ``flash_self_attention_fwd`` is the same core launched from the
  composed route, where the JAX package calls the library flash
  attention (``models/whisper.py:_flash_self_attention``, :141).
- ``mlp_block_fwd`` replaces ``fused_mlp_block`` (:500).  Up to D=512 the
  ``[rows, F]`` hidden stays in shared memory, one 32-column chunk at a
  time, while the next chunk of W1 and W2 streams in beside it.  Its wide
  form (D = 768 .. 1536, multiples of 128) is LN2, the fc1 GEMM with GELU
  into a bf16 ``[rows, F]`` hidden in device memory, the fc2 GEMM with the
  residual, and the final-LN capture.
- The stem and the MLP block count their wide form's launches apart, in
  ``wide_launches``; the library's ``wst_enc_narrow_max()`` draws the line.

Bounds at whisper-tiny, 64 clips: operations (see the source's note).
"""

from __future__ import annotations

import torch

from . import _build

_BF = torch.bfloat16


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
    if d % 32:
        raise ValueError(f"{what} takes D a multiple of 32 (got {d})")


def conv_stem_fwd(mel, conv1_w, conv1_b, conv2_w, conv2_b, pos) -> torch.Tensor:
    """mel ``[B, n_mels, T_mel]`` bf16 -> ``[B, T_mel//2, D]`` bf16.  The
    library picks the form by D: 64 output frames a CTA up to
    ``wst_enc_narrow_max()`` (counted in ``launches``), 32 above it up to
    ``wst_enc_wide_max()`` (the wide form, ``wide_launches``)."""
    mel = mel.contiguous()  # any strides: the even/odd split copies it anyway
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
    mt = mel.transpose(1, 2)
    even, odd = mt[:, 0::2].contiguous(), mt[:, 1::2].contiguous()
    w1t = conv1_w.detach().to(_BF).permute(0, 2, 1).reshape(d, 3 * n_mels).contiguous()
    w2t = conv2_w.detach().to(_BF).permute(0, 2, 1).reshape(d, 3 * d).contiguous()
    b1, b2 = _f32(conv1_b), _f32(conv2_b)
    posb = pos[:t].detach().to(_BF).contiguous()
    out = torch.empty((b, t, d), dtype=_BF, device=mel.device)
    err = lib.wst_conv_stem_fwd(even.data_ptr(), odd.data_ptr(), b, t, n_mels, d,
                                w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                                posb.data_ptr(), out.data_ptr(), _stream(mel.device))
    _build.check(err, "conv_stem_fwd")
    if d > lib.wst_enc_narrow_max():
        conv_stem_fwd.wide_launches += 1
    else:
        conv_stem_fwd.launches += 1
    return out


def ln_qkv_fwd(x, ln_g, ln_b, p, n_heads: int):
    """LN1 + q/k/v on rows ``[N, D]`` bf16 -> (q scaled, k, v), each ``[N, D]``."""
    _check_rows(x, "ln_qkv_fwd", 2)
    n, d = x.shape
    _check_width(d, "ln_qkv_fwd")
    wt = torch.cat([_bf16_nk(p["wq"]), _bf16_nk(p["wk"]), _bf16_nk(p["wv"])])
    bias = torch.cat([_f32(p["bq"]), torch.zeros(d, device=x.device), _f32(p["bv"])])
    g, bln = _f32(ln_g), _f32(ln_b)  # held until the launch: the kernel reads them
    q, k, v = (torch.empty_like(x) for _ in range(3))
    lib = _build.load_library()
    err = lib.wst_ln_qkv_fwd(x.data_ptr(), n, d, g.data_ptr(), bln.data_ptr(),
                             wt.data_ptr(), bias.data_ptr(), float(d // n_heads) ** -0.5,
                             q.data_ptr(), k.data_ptr(), v.data_ptr(), _stream(x.device))
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
    """x + bf16(attn Wo + bo) on rows ``[N, D]`` bf16."""
    _check_rows(attn, "out_proj_fwd", 2)
    _check_rows(x, "out_proj_fwd", 2)
    n, d = x.shape
    _check_width(d, "out_proj_fwd")
    if attn.shape != x.shape:
        raise ValueError("out_proj_fwd: attn and x must share one shape")
    wt, bias = _bf16_nk(wo), _f32(bo)
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.wst_out_proj_fwd(attn.data_ptr(), x.data_ptr(), n, d, wt.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), _stream(x.device))
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


_MLP_WIDTHS = (128, 256, 384, 512)


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
    """x + bf16(GELU(LN2(x) W1 + b1) W2 + b2) on rows ``[N, D]`` bf16.
    Returns out [, ln_f(out) at ``capture_dtype``] [, mlp_in, mlp_out].
    Up to ``wst_enc_narrow_max()`` the hidden stays in shared memory
    (``launches``); above it, D a multiple of 128 up to
    ``wst_enc_wide_max()``, the wide form keeps a bf16 ``[N, F]`` hidden as
    scratch in device memory (``wide_launches``)."""
    _check_rows(x, "mlp_block_fwd", 2)
    n, d = x.shape
    f = p["w1"].shape[1]
    lib = _build.load_library()
    wide = d > lib.wst_enc_narrow_max()
    if wide and (d % 128 or d > lib.wst_enc_wide_max() or f % 128):
        raise ValueError(f"mlp_block_fwd's wide form takes D a multiple of 128 up to "
                         f"{lib.wst_enc_wide_max()} and F a multiple of 128 (got D={d}, F={f})")
    if not wide and (d not in _MLP_WIDTHS or f % lib.wst_enc_mlp_chunk()):
        raise ValueError(f"mlp_block_fwd takes D in {_MLP_WIDTHS} and F a multiple of "
                         f"{lib.wst_enc_mlp_chunk()} (got D={d}, F={f})")
    out, cap, fg, fb, cap_mode, mlp_in, mlp_out = _mlp_outputs(x, capture, final_ln,
                                                               capture_dtype)
    # every converted operand is held in a local until the launch
    g, bln = _f32(ln_g), _f32(ln_b)
    w1t, w2t = _bf16_nk(p["w1"]), _bf16_nk(p["w2"])
    b1, b2 = _f32(p["b1"]), _f32(p["b2"])
    if wide:
        xln = mlp_in if capture else torch.empty_like(x)
        hid = torch.empty((n, f), dtype=_BF, device=x.device)
        err = lib.wst_mlp_block_wide_fwd(x.data_ptr(), n, d, f, g.data_ptr(), bln.data_ptr(),
                                         w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                                         b2.data_ptr(), _ptr(fg), _ptr(fb), cap_mode,
                                         out.data_ptr(), _ptr(cap), xln.data_ptr(),
                                         hid.data_ptr(), _ptr(mlp_out), _stream(x.device))
    else:
        err = lib.wst_mlp_block_fwd(x.data_ptr(), n, d, f, g.data_ptr(),
                                    bln.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                                    w2t.data_ptr(), b2.data_ptr(), _ptr(fg), _ptr(fb), cap_mode,
                                    out.data_ptr(), _ptr(cap), _ptr(mlp_in), _ptr(mlp_out),
                                    _stream(x.device))
    _build.check(err, "mlp_block_fwd")
    if wide:
        mlp_block_fwd.wide_launches += 1
    else:
        mlp_block_fwd.launches += 1
    return _mlp_result(out, cap, mlp_in, mlp_out, capture)


for _fn in (conv_stem_fwd, ln_qkv_fwd, self_attention_fwd, flash_self_attention_fwd,
            out_proj_fwd, mlp_block_fwd):
    _fn.launches = 0
conv_stem_fwd.wide_launches = mlp_block_fwd.wide_launches = 0
