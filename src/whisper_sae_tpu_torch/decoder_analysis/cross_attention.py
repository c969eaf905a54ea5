"""Decoder-to-encoder cross-attention probes (counterpart of
``whisper_sae_tpu/decoder_analysis/cross_attention.py``): per layer and
head, which encoder frames (and so which stretch of audio) the decoder
reads from.
"""

from __future__ import annotations

import torch

from ..models.whisper import WhisperArch, _layer, _layer_norm, _mlp, _n_layers, encoder_forward
from ..utils.device import f32_matmuls


@torch.no_grad()
def cross_attention_maps(params: dict, mel: torch.Tensor, arch: WhisperArch,
                         token_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-attention probabilities of every decoder layer and head,
    ``[L_dec, B, heads, T_dec, T_enc]`` f32, from a decoder pass over
    ``token_ids`` (default: the start token)."""
    with f32_matmuls():
        enc_hidden, _ = encoder_forward(params, mel, arch)
        dec = params["decoder"]
        if token_ids is None:
            token_ids = torch.full((mel.shape[0], 1), arch.decoder_start_token_id,
                                   dtype=torch.long, device=mel.device)
        x = dec["tok"][token_ids] + dec["pos"][: token_ids.shape[1]]
        nh, hd = arch.num_heads, arch.head_dim
        maps = []
        for i in range(_n_layers(dec["layers"])):
            lp = _layer(dec["layers"], i)
            h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
            x = x + _self_attn(h, lp["attn"], nh, hd, causal=True)
            h = _layer_norm(x, lp["ln_x_g"], lp["ln_x_b"])
            attn_out, probs = _attn_with_probs(h, enc_hidden, lp["xattn"], nh, hd)
            maps.append(probs)
            x = x + attn_out
            x = x + _mlp(_layer_norm(x, lp["ln2_g"], lp["ln2_b"]), lp["mlp"])
    return torch.stack(maps)


def _split_heads(y: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    b, t, _ = y.shape
    return y.reshape(b, t, nh, hd).transpose(1, 2)


def _merge_heads(y: torch.Tensor) -> torch.Tensor:
    b, nh, t, hd = y.shape
    return y.transpose(1, 2).reshape(b, t, nh * hd)


def _self_attn(x, p: dict, nh: int, hd: int, causal: bool) -> torch.Tensor:
    q = _split_heads((x @ p["wq"] + p["bq"]) * hd**-0.5, nh, hd)
    k = _split_heads(x @ p["wk"], nh, hd)
    v = _split_heads(x @ p["wv"] + p["bv"], nh, hd)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        t = x.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return _merge_heads(a @ v) @ p["wo"] + p["bo"]


def _attn_with_probs(x_q, x_kv, p: dict, nh: int, hd: int):
    """Attention of ``x_q`` over ``x_kv`` -> (output, f32 probabilities
    ``[B, heads, T_q, T_kv]``)."""
    q = _split_heads((x_q @ p["wq"] + p["bq"]) * hd**-0.5, nh, hd)
    k = _split_heads(x_kv @ p["wk"], nh, hd)
    v = _split_heads(x_kv @ p["wv"] + p["bv"], nh, hd)
    probs = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1)
    out = _merge_heads(probs.to(v.dtype) @ v) @ p["wo"] + p["bo"]
    return out, probs


def top_attended_frames(maps: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The ``k`` encoder frames with the most head-averaged attention for
    each decoder layer and position: ``[L, B, T_dec, k]`` frame indices."""
    return torch.topk(maps.mean(dim=2), k, dim=-1).indices


def attention_entropy(maps: torch.Tensor) -> torch.Tensor:
    """Attention entropy per layer, head and position ``[L, B, heads,
    T_dec]``: low means a sharply localised alignment."""
    p = maps.clamp(1e-10, 1.0)
    return -(p * torch.log(p)).sum(dim=-1)
