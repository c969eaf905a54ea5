"""The fused Whisper-encoder blocks: plain PyTorch versions and dispatch.

Counterpart of ``whisper_sae_tpu/ops/pallas_encoder.py``.  Each plain
version repeats its Pallas kernel's arithmetic (``_ln_f32`` :57-61, the
attention bodies :179-282, the MLP body :387-425, the conv stem
:528-568): bf16 operands with f32 products (``mm_f32``), every bias
added in f32 before one rounding to bf16, LN and softmax in f32, pad key
columns at -1e30, ``bf16(p) @ v`` over the f32 sum of ``p``, the
residual added in bf16, the final-LN capture taken from the bf16-rounded
layer output.  GELU is the exact erf GELU; the Pallas kernels use an erf
polynomial (3.4e-5 abs, under bf16 rounding), a workaround for Mosaic
that is not ported.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
hand-written kernel (``ops/cuda_encoder.py``), which raises on a shape it cannot take; there is no fallback.  ``plain_calls``
counts calls of the plain versions, so a run on the card can show that it
used none.  ``fused_encoder_supported`` is the route's gate, the port's
counterpart of ``pallas_encoder.supported``: where it fails the model
takes the composed path, as the JAX package does.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from ..utils.device import mm_f32

LN_EPS = 1e-5
MASKED_SCORE = -1e30
# the fused route's gate (pallas_encoder.py:664-692): head dim of the
# attention core, the widest D, the longest padded T
HEAD_DIM = 64
MAX_D = 1536
MAX_T_PAD = 2048

plain_calls: Counter = Counter()


def ln_f32(x32: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row layer norm in f32 (population variance, eps 1e-5)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS) * g.float() + b.float()


def _bf16_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b for bf16 tensors, rounded once."""
    return (a.float() + b.float()).bfloat16()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def conv_stem_plain(mel, conv1_w, conv1_b, conv2_w, conv2_b, pos) -> torch.Tensor:
    """GELU(conv2(GELU(conv1(mel)))) + pos as six shifted products on the
    even and odd mel columns.  mel ``[B, n_mels, T_mel]`` -> ``[B, T_mel//2, D]`` bf16."""
    plain_calls["conv_stem"] += 1
    mt = mel.to(torch.bfloat16).transpose(1, 2)
    even, odd = mt[:, 0::2], mt[:, 1::2]
    t = even.shape[1]
    w1 = conv1_w.to(torch.bfloat16)
    w2 = conv2_w.to(torch.bfloat16)

    def down(a):  # row t holds a[t-1]; a zero row enters at t=0
        return F.pad(a, (0, 0, 1, 0))[:, :-1]

    def up(a):  # row t holds a[t+1]; a zero row enters at the end
        return F.pad(a, (0, 0, 0, 1))[:, 1:]

    def tap(a, w, j):
        return mm_f32(a, w[:, :, j].t())

    b1, b2 = conv1_b.float(), conv2_b.float()
    h_even = tap(down(odd), w1, 0) + tap(even, w1, 1) + tap(odd, w1, 2) + b1
    h_odd = tap(even, w1, 0) + tap(odd, w1, 1) + tap(up(even), w1, 2) + b1
    h_even = F.gelu(h_even).bfloat16()
    h_odd = F.gelu(h_odd).bfloat16()
    out = tap(down(h_odd), w2, 0) + tap(h_even, w2, 1) + tap(h_odd, w2, 2) + b2
    return _bf16_add(F.gelu(out).bfloat16(), pos[:t].to(torch.bfloat16))


def conv_stem_route_plain(mel, conv1_w, conv1_b, conv2_w, conv2_b, pos) -> torch.Tensor:
    """The card's route of the conv stem (``cuda_encoder.conv_stem_fwd``)
    written out step by step, for the tests: the prep's time-major mel
    with a zero row at each end of every clip, conv1 as three tap products
    over its frames f + j, the GELU epilogue rounded into a hidden whose
    row 0 is zero (h[-1]), conv2 as three tap products over the hidden's
    rows 2t + j (stride 2), then the GELU and positions epilogue.  mel
    ``[B, n_mels, T_mel]`` -> ``[B, T_mel//2, D]`` bf16."""
    b, n_mels, t_mel = mel.shape
    t = t_mel // 2
    d = conv1_w.shape[0]
    w1, w2 = conv1_w.to(torch.bfloat16), conv2_w.to(torch.bfloat16)
    mel_pad = torch.zeros(b, t_mel + 2, n_mels, dtype=torch.bfloat16, device=mel.device)
    mel_pad[:, 1:-1] = mel.to(torch.bfloat16).transpose(1, 2)
    acc = sum(mm_f32(mel_pad[:, j:j + t_mel], w1[:, :, j].t()) for j in range(3))
    h_pad = torch.zeros(b, t_mel + 1, d, dtype=torch.bfloat16, device=mel.device)
    h_pad[:, 1:] = F.gelu(acc + conv1_b.float()).bfloat16()
    acc = sum(mm_f32(h_pad[:, j:j + 2 * t:2], w2[:, :, j].t()) for j in range(3))
    return _bf16_add(F.gelu(acc + conv2_b.float()).bfloat16(), pos[:t].to(torch.bfloat16))


def ln_qkv_plain(x, ln_g, ln_b, p, n_heads: int):
    """LN1 and the q/k/v products: q = bf16((xln Wq + bq) * hd**-0.5),
    k = bf16(xln Wk), v = bf16(xln Wv + bv), each ``[..., D]``."""
    plain_calls["ln_qkv"] += 1
    d = x.shape[-1]
    xln = ln_f32(x.float(), ln_g, ln_b).bfloat16()
    scale = float(d // n_heads) ** -0.5
    q = ((mm_f32(xln, p["wq"].to(torch.bfloat16)) + p["bq"].float()) * scale).bfloat16()
    k = mm_f32(xln, p["wk"].to(torch.bfloat16)).bfloat16()
    v = (mm_f32(xln, p["wv"].to(torch.bfloat16)) + p["bv"].float()).bfloat16()
    return q, k, v


def self_attention_plain(q, k, v, n_heads: int, t_real: int | None = None) -> torch.Tensor:
    """softmax(q k^T) v per head over ``[B, T, D]`` bf16 with the heads in
    column blocks (q already scaled); key columns >= ``t_real`` masked."""
    plain_calls["self_attention"] += 1
    b, t, d = q.shape
    hd = d // n_heads
    t_real = t if t_real is None else t_real
    masked = torch.arange(k.shape[1], device=q.device) >= t_real
    outs = []
    for h in range(n_heads):
        sl = slice(h * hd, (h + 1) * hd)
        s = mm_f32(q[..., sl], k[..., sl].transpose(1, 2))  # [B, T, T]
        s = s.masked_fill(masked, MASKED_SCORE)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        outs.append((mm_f32(p.bfloat16(), v[..., sl]) / denom).bfloat16())
    return torch.cat(outs, dim=-1)


def out_proj_plain(attn, x, wo, bo) -> torch.Tensor:
    """x + bf16(attn Wo + bo), rounded once more to bf16."""
    plain_calls["out_proj"] += 1
    y = (mm_f32(attn, wo.to(torch.bfloat16)) + bo.float()).bfloat16()
    return _bf16_add(x, y)


def attention_block_plain(x, ln_g, ln_b, p, n_heads: int, t_real: int | None = None):
    """x + out_proj(MHA(LN1(x))) on ``[B, T, D]`` bf16 (``fused_attention_block``)."""
    q, k, v = ln_qkv_plain(x, ln_g, ln_b, p, n_heads)
    return out_proj_plain(self_attention_plain(q, k, v, n_heads, t_real), x, p["wo"], p["bo"])


def mlp_block_plain(x, ln_g, ln_b, p, capture: bool = False, final_ln=None,
                    capture_dtype=torch.bfloat16):
    """x + bf16(GELU(LN2(x) W1 + b1) W2 + b2) on ``[N, D]`` bf16 rows
    (``fused_mlp_block``).  Returns out [, ln_f(out)] [, mlp_in, mlp_out]."""
    plain_calls["mlp_block"] += 1
    xln = ln_f32(x.float(), ln_g, ln_b).bfloat16()
    h = F.gelu(mm_f32(xln, p["w1"].to(torch.bfloat16)) + p["b1"].float()).bfloat16()
    y = (mm_f32(h, p["w2"].to(torch.bfloat16)) + p["b2"].float()).bfloat16()
    out = _bf16_add(x, y)
    outs = [out]
    if final_ln is not None:
        outs.append(ln_f32(out.float(), *final_ln).to(capture_dtype))
    if capture:
        outs += [xln, y]
    return tuple(outs) if len(outs) > 1 else out


# ---------------------------------------------------------------------------
# dispatch: CPU -> plain version, CUDA -> kernel
# ---------------------------------------------------------------------------


def fused_encoder_supported(t: int, d: int, n_heads: int) -> bool:
    """The fused encoder blocks hold the geometry: ``t_pad = ceil128(T) <=
    2048``, D a multiple of 128 up to 1536, head dim 64 (every Whisper from
    tiny to large-v3).  The JAX package's ``_use_fused_encoder`` also asks
    for the TPU; here the kernels run on the card and their plain versions
    on the CPU, so the route is the same on both."""
    t_pad = -(-t // 128) * 128
    return (d % n_heads == 0 and d // n_heads == HEAD_DIM and d % 128 == 0 and d <= MAX_D
            and t_pad <= MAX_T_PAD)


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def conv_stem(mel: torch.Tensor, enc: dict) -> torch.Tensor:
    """The fused conv stem (``fused_conv_stem``) on bf16 mel ``[B, n_mels, T_mel]``."""
    args = (mel, enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"], enc["pos"])
    if _route(mel, "conv_stem"):
        from . import cuda_encoder

        return cuda_encoder.conv_stem_fwd(*args)
    return conv_stem_plain(*args)


def attention_block(x, ln_g, ln_b, p, n_heads: int, t_real: int | None = None):
    """The fused attention sublayer (``fused_attention_block``): three
    launches on the card (LN1+QKV, the core, the out-projection)."""
    if _route(x, "attention_block"):
        from . import cuda_encoder

        return cuda_encoder.attention_block_fwd(x, ln_g, ln_b, p, n_heads, t_real)
    return attention_block_plain(x, ln_g, ln_b, p, n_heads, t_real)


def flash_self_attention(q, k, v, n_heads: int) -> torch.Tensor:
    """The attention core alone on the composed route, where the JAX
    package calls the library flash attention (``models/whisper.py:141``)."""
    if _route(q, "flash_self_attention"):
        from . import cuda_encoder

        return cuda_encoder.flash_self_attention_fwd(q, k, v, n_heads)
    return self_attention_plain(q, k, v, n_heads)


def mlp_block(x, ln_g, ln_b, p, capture: bool = False, final_ln=None,
              capture_dtype=torch.bfloat16):
    """The fused MLP sublayer (``fused_mlp_block``), all four output modes."""
    if _route(x, "mlp_block"):
        from . import cuda_encoder

        return cuda_encoder.mlp_block_fwd(x, ln_g, ln_b, p, capture, final_ln, capture_dtype)
    return mlp_block_plain(x, ln_g, ln_b, p, capture, final_ln, capture_dtype)
