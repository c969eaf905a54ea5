"""Whisper encoder/decoder forward with activation capture.

Counterpart of ``whisper_sae_tpu/models/whisper.py``: the same parameter
tree (nested dicts with the JAX package's keys, linear weights in the
``x @ W`` layout, the layers of each stack stacked on a leading ``[L]``
axis), the same forwards, and ``extract_activations`` with the same
keys, dtypes and capture semantics.  Architecture facts follow HF
``transformers`` Whisper: conv stem Conv1d(k3,p1) GELU Conv1d(k3,s2,p1)
GELU + sinusoidal positions; pre-LN blocks; q/v/out biased, k unbiased;
q scaled by head_dim**-0.5; exact GELU; LN eps 1e-5; the decoder's
learned positions, causal self-attention and cross-attention.

Routes, as in the JAX package:

- bf16 with ``use_fused`` (the extraction path), where
  ``ops.encoder.fused_encoder_supported`` holds (every Whisper from tiny
  to large-v3; the JAX package's ``_use_fused_encoder`` gate, :86-93):
  the conv stem, the attention block and the MLP block with the final-LN
  capture go through ``ops/encoder.py``, i.e. the hand-written kernels on
  the card and their plain versions on the CPU.
- everything else is the composed path in torch ops; bf16 non-causal
  self-attention with ``tq == tk >= 256`` sends its core to the same
  attention kernel, where JAX calls the library flash attention.  The
  f32 parity mode runs with TF32 off (``f32_matmuls``).

Decoding (``greedy_decode_cached``, ``greedy_decode``, ``transcribe``)
follows the JAX package's loops step for step: the same static-shape
caches, dtypes at each op, forcing and EOS freeze; the loop runs eagerly
on the host, one cached step (``_decode_step``) a token.

Spans (``utils/profiling.span``, profiler ranges only while a profiler
runs): ``extract.call`` (``extract_activations``), ``encoder.forward``
with ``encoder.attention`` and ``encoder.mlp`` around each fused layer's
blocks, ``decoder.forward``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..data.mel import log_mel_spectrogram
from ..ops import encoder as encoder_ops
from ..utils.device import f32_matmuls, mm_f32, resolve_device
from ..utils.profiling import span

LN_EPS = 1e-5


@dataclass(frozen=True)
class WhisperArch:
    """Static architecture hyperparameters."""

    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    ffn_dim: int = 1536
    n_mels: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


_ARCHS = {
    "openai/whisper-tiny": WhisperArch(384, 4, 4, 6, 1536),
    "openai/whisper-base": WhisperArch(512, 6, 6, 8, 2048),
    "openai/whisper-small": WhisperArch(768, 12, 12, 12, 3072),
    "openai/whisper-medium": WhisperArch(1024, 24, 24, 16, 4096),
    "openai/whisper-large": WhisperArch(1280, 32, 32, 20, 5120),
    "openai/whisper-large-v2": WhisperArch(1280, 32, 32, 20, 5120),
    "openai/whisper-large-v3": WhisperArch(1280, 32, 32, 20, 5120, n_mels=128, vocab_size=51866),
}


def arch_for(model_name: str) -> WhisperArch:
    return _ARCHS[model_name]


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` layer tree (views)."""
    return _tree_map(lambda a: a[i], stack)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """f32 leaves cast to ``dtype``, others kept (the JAX ``tree_map``)."""
    return _tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a, params)


def params_to(params: dict, device) -> dict:
    return _tree_map(lambda a: a.to(device), params)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper(generator: torch.Generator, arch: WhisperArch) -> dict:
    """Random parameters (normal * 0.02 weights, zero biases, unit LN
    gains) on the generator's device, in the tree of the JAX
    ``init_whisper``.  A CUDA generator makes whisper-large's 1.55 B
    parameters on the card; its draws differ from a CPU generator's."""
    d, f = arch.d_model, arch.ffn_dim
    dev = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=dev) * 0.02

    def zeros(n):
        return torch.zeros(n, device=dev)

    def ones(n):
        return torch.ones(n, device=dev)

    def attn_p():
        return {"wq": randn(d, d), "bq": zeros(d), "wk": randn(d, d),
                "wv": randn(d, d), "bv": zeros(d), "wo": randn(d, d), "bo": zeros(d)}

    def enc_layer():
        return {
            "attn": attn_p(), "ln1_g": ones(d), "ln1_b": zeros(d),
            "mlp": {"w1": randn(d, f), "b1": zeros(f), "w2": randn(f, d), "b2": zeros(d)},
            "ln2_g": ones(d), "ln2_b": zeros(d),
        }

    def dec_layer():
        lp = enc_layer()
        lp.update(xattn=attn_p(), ln_x_g=ones(d), ln_x_b=zeros(d))
        return lp

    return {
        "encoder": {
            "conv1_w": randn(d, arch.n_mels, 3), "conv1_b": zeros(d),
            "conv2_w": randn(d, d, 3), "conv2_b": zeros(d),
            "pos": torch.from_numpy(_sinusoids(arch.max_source_positions, d)).to(dev),
            "layers": _stack([enc_layer() for _ in range(arch.encoder_layers)]),
            "ln_f_g": ones(d), "ln_f_b": zeros(d),
        },
        "decoder": {
            "tok": randn(arch.vocab_size, d), "pos": randn(arch.max_target_positions, d),
            "layers": _stack([dec_layer() for _ in range(arch.decoder_layers)]),
            "ln_f_g": ones(d), "ln_f_b": zeros(d),
        },
    }


def _stack(layers: list[dict]) -> dict:
    first = layers[0]
    return {k: _stack([lp[k] for lp in layers]) if isinstance(first[k], dict)
            else torch.stack([lp[k] for lp in layers]) for k in first}


def _leaf_from_numpy(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree: dict, device=None) -> dict:
    """A JAX-package Whisper parameter tree (numpy or jax arrays) ->
    the same tree of tensors: same keys, same ``x @ W`` layout, same
    stacked ``[L, ...]`` layers."""
    return _tree_map(lambda a: _leaf_from_numpy(a).to(device), tree)


def from_hf_state_dict(sd: dict, arch: WhisperArch) -> dict:
    """Parameters from a HF ``WhisperForConditionalGeneration`` /
    ``WhisperModel`` state dict (tensors or arrays, with or without the
    ``model.`` prefix); linear weights are transposed to ``x @ W``."""
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""

    def g(name):
        return torch.as_tensor(np.asarray(sd[prefix + name])).float()

    def attn_p(base):
        return {"wq": g(f"{base}.q_proj.weight").T, "bq": g(f"{base}.q_proj.bias"),
                "wk": g(f"{base}.k_proj.weight").T, "wv": g(f"{base}.v_proj.weight").T,
                "bv": g(f"{base}.v_proj.bias"), "wo": g(f"{base}.out_proj.weight").T,
                "bo": g(f"{base}.out_proj.bias")}

    def layer(base, cross):
        lp = {
            "attn": attn_p(f"{base}.self_attn"),
            "ln1_g": g(f"{base}.self_attn_layer_norm.weight"),
            "ln1_b": g(f"{base}.self_attn_layer_norm.bias"),
            "mlp": {"w1": g(f"{base}.fc1.weight").T, "b1": g(f"{base}.fc1.bias"),
                    "w2": g(f"{base}.fc2.weight").T, "b2": g(f"{base}.fc2.bias")},
            "ln2_g": g(f"{base}.final_layer_norm.weight"),
            "ln2_b": g(f"{base}.final_layer_norm.bias"),
        }
        if cross:
            lp.update(xattn=attn_p(f"{base}.encoder_attn"),
                      ln_x_g=g(f"{base}.encoder_attn_layer_norm.weight"),
                      ln_x_b=g(f"{base}.encoder_attn_layer_norm.bias"))
        return lp

    params = {
        "encoder": {
            "conv1_w": g("encoder.conv1.weight"), "conv1_b": g("encoder.conv1.bias"),
            "conv2_w": g("encoder.conv2.weight"), "conv2_b": g("encoder.conv2.bias"),
            "pos": g("encoder.embed_positions.weight"),
            "layers": _stack([layer(f"encoder.layers.{i}", False)
                              for i in range(arch.encoder_layers)]),
            "ln_f_g": g("encoder.layer_norm.weight"), "ln_f_b": g("encoder.layer_norm.bias"),
        },
        "decoder": {
            "tok": g("decoder.embed_tokens.weight"), "pos": g("decoder.embed_positions.weight"),
            "layers": _stack([layer(f"decoder.layers.{i}", True)
                              for i in range(arch.decoder_layers)]),
            "ln_f_g": g("decoder.layer_norm.weight"), "ln_f_b": g("decoder.layer_norm.bias"),
        },
    }
    return _tree_map(lambda a: a.contiguous(), params)


def _arch_from_hf_config(cfg: dict) -> WhisperArch:
    return WhisperArch(
        d_model=cfg["d_model"], encoder_layers=cfg["encoder_layers"],
        decoder_layers=cfg["decoder_layers"], num_heads=cfg["encoder_attention_heads"],
        ffn_dim=cfg["encoder_ffn_dim"], n_mels=cfg["num_mel_bins"],
        max_source_positions=cfg["max_source_positions"],
        max_target_positions=cfg["max_target_positions"], vocab_size=cfg["vocab_size"],
        decoder_start_token_id=cfg["decoder_start_token_id"], eos_token_id=cfg["eos_token_id"],
    )


def from_hf_torch(model) -> tuple[dict, WhisperArch]:
    """(params, arch) from a ``transformers`` ``WhisperForConditionalGeneration``
    or ``WhisperModel`` instance; the params are CPU tensors in the
    ``x @ W`` layout, as :func:`load_pretrained` gives them."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    arch = _arch_from_hf_config(model.config.to_dict())
    return from_hf_state_dict(sd, arch), arch


def _hf_snapshot(model_name: str) -> Path:
    """The local HF hub snapshot directory of ``model_name`` (no download)."""
    hub = os.environ.get("HF_HUB_CACHE") or str(
        Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub")
    snaps = Path(hub) / f"models--{model_name.replace('/', '--')}" / "snapshots"
    found = sorted(snaps.glob("*/config.json")) if snaps.is_dir() else []
    if not found:
        raise FileNotFoundError(f"no local snapshot of {model_name} under {hub}")
    return found[-1].parent


def load_pretrained(model_name: str, path: str | Path | None = None) -> tuple[dict, WhisperArch]:
    """Pretrained weights from a local directory holding ``config.json``
    and ``pytorch_model.bin`` (or ``model.safetensors``), by default the
    HF hub cache's snapshot of ``model_name``.  Nothing is downloaded;
    a missing snapshot raises ``FileNotFoundError``."""
    root = Path(path) if path is not None else _hf_snapshot(model_name)
    arch = _arch_from_hf_config(json.loads((root / "config.json").read_text()))
    if (root / "model.safetensors").exists():
        from safetensors.torch import load_file

        sd = load_file(str(root / "model.safetensors"))
    else:
        sd = torch.load(root / "pytorch_model.bin", map_location="cpu", weights_only=True)
    return from_hf_state_dict(sd, arch), arch


# ---------------------------------------------------------------------------
# building blocks (the composed path)
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LN in f32, returned in ``x``'s dtype."""
    return encoder_ops.ln_f32(x.float(), g, b).to(x.dtype)


def _use_flash_attention(tq: int, tk: int, dtype) -> bool:
    """Long bf16 self-attention (the encoder's 1500 frames) runs its core
    in the hand-written attention kernel, where JAX calls the library
    flash attention; the f32 parity mode and short sequences do not."""
    return dtype == torch.bfloat16 and tq == tk and tq >= 256


def _attention(x_q, x_kv, p: dict, num_heads: int, causal: bool) -> torch.Tensor:
    b, tq, d = x_q.shape
    tk = x_kv.shape[1]
    hd = d // num_heads
    q = (x_q @ p["wq"] + p["bq"]) * hd**-0.5

    if not causal and tq * num_heads * 2 <= d and tk >= 8 * tq:
        # few-query cross-attention (the BOS capture pass), reassociated
        # exactly as the JAX package does:
        #   scores_h = (q_h Wk_h^T) enc^T,  attn_h (enc Wv_h + bv_h) = (attn_h enc) Wv_h + bv_h
        # scores and softmax in f32, everything else in the input dtype
        q4 = q.reshape(b, tq, num_heads, hd)
        u = torch.einsum("bqhe,dhe->bqhd", q4, p["wk"].reshape(d, num_heads, hd))
        scores = torch.einsum("bqhd,bkd->bhqk", u.float(), x_kv.float())
        attn = torch.softmax(scores, dim=-1).to(x_kv.dtype)
        c = torch.einsum("bhqk,bkd->bqhd", attn, x_kv)
        out = torch.einsum("bqhd,dhe->bqhe", c, p["wv"].reshape(d, num_heads, hd))
        return (out.reshape(b, tq, d) + p["bv"]) @ p["wo"] + p["bo"]

    k = x_kv @ p["wk"]
    v = x_kv @ p["wv"] + p["bv"]
    if not causal and _use_flash_attention(tq, tk, q.dtype):
        out = encoder_ops.flash_self_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                               num_heads)
    else:
        qh = q.reshape(b, tq, num_heads, hd).transpose(1, 2)
        kh = k.reshape(b, tk, num_heads, hd).transpose(1, 2)
        vh = v.reshape(b, tk, num_heads, hd).transpose(1, 2)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        if causal:
            mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(diagonal=tk - tq)
            scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (attn @ vh).transpose(1, 2).reshape(b, tq, d)
    return out @ p["wo"] + p["bo"]


def _mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _encoder_layer(x, lp: dict, num_heads: int):
    """-> (layer output, mlp input (post-LN2), mlp output (pre-residual))."""
    h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    x = x + _attention(h, h, lp["attn"], num_heads, causal=False)
    mlp_in = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    mlp_out = _mlp(mlp_in, lp["mlp"])
    return x + mlp_out, mlp_in, mlp_out


def _decoder_layer(x, enc, lp: dict, num_heads: int):
    """-> (layer output, mlp input, mlp output)."""
    h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    x = x + _attention(h, h, lp["attn"], num_heads, causal=True)
    h = _layer_norm(x, lp["ln_x_g"], lp["ln_x_b"])
    x = x + _attention(h, enc, lp["xattn"], num_heads, causal=False)
    mlp_in = _layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    mlp_out = _mlp(mlp_in, lp["mlp"])
    return x + mlp_out, mlp_in, mlp_out


def _n_layers(stack: dict) -> int:
    return stack["ln1_g"].shape[0]


# ---------------------------------------------------------------------------
# forward passes with capture
# ---------------------------------------------------------------------------


def _fused_encoder_layers(x, enc: dict, arch: WhisperArch, with_mlp: bool,
                          final_ln: tuple | None = None, capture_dtype=torch.bfloat16):
    """The encoder stack through the fused blocks: per layer the attention
    block and the MLP block (with the final-LN capture when ``final_ln``
    is given).  The sequence is not padded.  Returns (x, captures
    ``[L, B, T, D]``, (mlp_ins, mlp_outs) or None)."""
    b, t, d = x.shape
    caps, mins, mouts = [], [], []
    for i in range(_n_layers(enc["layers"])):
        lp = _layer(enc["layers"], i)
        with span("encoder.attention"):
            x = encoder_ops.attention_block(x, lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                            arch.num_heads)
        with span("encoder.mlp"):
            outs = encoder_ops.mlp_block(x.reshape(b * t, d), lp["ln2_g"], lp["ln2_b"],
                                         lp["mlp"], capture=with_mlp, final_ln=final_ln,
                                         capture_dtype=capture_dtype)
        if not isinstance(outs, tuple):
            outs = (outs,)
        x = outs[0].reshape(b, t, d)
        caps.append(outs[1].reshape(b, t, d) if final_ln is not None else x)
        if with_mlp:
            mins.append(outs[-2].reshape(b, t, d))
            mouts.append(outs[-1].reshape(b, t, d))
    pair = (torch.stack(mins), torch.stack(mouts)) if with_mlp else None
    return x, torch.stack(caps), pair


def composed_stem(mel: torch.Tensor, enc: dict) -> torch.Tensor:
    """The conv stem as library calls: conv1 + GELU, conv2 (stride 2) +
    GELU, to ``[B, T, D]``, plus the positions (the composed path's
    stem; the caller sets the matmul precision)."""
    x = F.conv1d(mel, enc["conv1_w"], padding=1) + enc["conv1_b"][None, :, None]
    x = F.gelu(x)
    x = F.conv1d(x, enc["conv2_w"], stride=2, padding=1) + enc["conv2_b"][None, :, None]
    x = F.gelu(x).transpose(1, 2)
    return x + enc["pos"][: x.shape[1]]


@span("encoder.forward")
def encoder_forward(params: dict, mel: torch.Tensor, arch: WhisperArch, with_mlp: bool = False,
                    use_fused: bool = True, capture_final_ln: bool = False, capture_dtype=None):
    """Encoder forward on mel ``[B, n_mels, T_mel]``.

    Returns (last hidden ``[B, T, D]`` after the final LN, per-layer
    outputs ``[L, B, T, D]`` -- raw, or final-LN'd at ``capture_dtype``
    when ``capture_final_ln`` [, (mlp_ins, mlp_outs) when ``with_mlp``]),
    as the JAX ``encoder_forward``.  bf16 mel with ``use_fused`` takes
    the fused blocks where their gate holds; anything else the composed
    path."""
    enc = params["encoder"]
    t_out = mel.shape[2] // 2
    if (use_fused and mel.dtype == torch.bfloat16
            and encoder_ops.fused_encoder_supported(t_out, arch.d_model, arch.num_heads)):
        x = encoder_ops.conv_stem(mel, enc)
        cap_dt = capture_dtype if capture_dtype is not None else x.dtype
        final_ln = (enc["ln_f_g"].float(), enc["ln_f_b"].float()) if capture_final_ln else None
        x, layer_outputs, mlp_pair = _fused_encoder_layers(
            x, enc, arch, with_mlp, final_ln=final_ln, capture_dtype=cap_dt)
        if capture_final_ln and cap_dt == x.dtype:
            # the last layer's LN'd capture IS the final hidden state
            last = layer_outputs[-1]
        else:
            last = _layer_norm(x, enc["ln_f_g"], enc["ln_f_b"])
        return (last, layer_outputs, mlp_pair) if with_mlp else (last, layer_outputs)

    x = composed_stem(mel, enc)
    outs, mins, mouts = [], [], []
    for i in range(_n_layers(enc["layers"])):
        x, mlp_in, mlp_out = _encoder_layer(x, _layer(enc["layers"], i), arch.num_heads)
        outs.append(x)
        mins.append(mlp_in)
        mouts.append(mlp_out)
    layer_outputs = torch.stack(outs)
    last = _layer_norm(x, enc["ln_f_g"], enc["ln_f_b"])
    if capture_final_ln:
        cap_dt = capture_dtype if capture_dtype is not None else x.dtype
        layer_outputs = _layer_norm(layer_outputs.to(cap_dt), enc["ln_f_g"].float(),
                                    enc["ln_f_b"].float())
    if with_mlp:
        return last, layer_outputs, (torch.stack(mins), torch.stack(mouts))
    return last, layer_outputs


@span("decoder.forward")
def decoder_forward(params: dict, token_ids: torch.Tensor, enc_hidden: torch.Tensor,
                    arch: WhisperArch, with_mlp: bool = False):
    """Decoder forward over ``token_ids`` ``[B, T_dec]`` (full sequence, no
    KV cache).  Returns (last hidden after the final LN, per-layer outputs
    ``[L, B, T_dec, D]`` [, (mlp_ins, mlp_outs) when ``with_mlp``])."""
    dec = params["decoder"]
    t = token_ids.shape[1]
    x = dec["tok"][token_ids] + dec["pos"][:t]
    enc_hidden = enc_hidden.to(x.dtype)
    outs, mins, mouts = [], [], []
    for i in range(_n_layers(dec["layers"])):
        x, mlp_in, mlp_out = _decoder_layer(x, enc_hidden, _layer(dec["layers"], i),
                                            arch.num_heads)
        outs.append(x)
        mins.append(mlp_in)
        mouts.append(mlp_out)
    last = _layer_norm(x, dec["ln_f_g"], dec["ln_f_b"])
    if with_mlp:
        return last, torch.stack(outs), (torch.stack(mins), torch.stack(mouts))
    return last, torch.stack(outs)


@torch.no_grad()
@span("extract.call")
def extract_activations(params: dict, mel: torch.Tensor, arch: WhisperArch,
                        apply_layer_norm: bool = True, with_decoder: bool = True,
                        compute_dtype: torch.dtype | None = None, with_mlp: bool = False,
                        capture_dtype: torch.dtype | None = None,
                        use_fused_encoder: bool = True) -> dict[str, torch.Tensor]:
    """The encoder, then the decoder on one BOS token; every layer's output.

    ``compute_dtype=torch.bfloat16`` runs the blocks in bf16 (LN and
    softmax in f32) through the fused kernels; ``capture_dtype`` is the
    dtype of the returned captures (default f32).  The all-defaults path
    is full f32 with TF32 off, the parity mode.

    Returns a dict with ``encoder`` ``[L_enc, B, T, D]`` (final-LN'd when
    ``apply_layer_norm``), ``encoder_last`` ``[B, T, D]`` f32, ``decoder``
    ``[L_dec, B, 1, D]`` (when ``with_decoder``) and the raw
    ``{encoder,decoder}_mlp_{in,out}`` pairs (when ``with_mlp``).
    """
    out_dt = torch.float32 if capture_dtype is None else capture_dtype
    if compute_dtype is not None:
        params = cast_params(params, compute_dtype)
        mel = mel.to(compute_dtype)
    with f32_matmuls():
        fwd = encoder_forward(params, mel, arch, with_mlp=with_mlp, use_fused=use_fused_encoder,
                              capture_final_ln=apply_layer_norm, capture_dtype=out_dt)
        enc_last, enc_layers = fwd[0], fwd[1]
        out = {"encoder": enc_layers.to(out_dt), "encoder_last": enc_last.float()}
        if with_mlp:
            out["encoder_mlp_in"] = fwd[2][0].to(out_dt)
            out["encoder_mlp_out"] = fwd[2][1].to(out_dt)
        if with_decoder:
            bos = torch.full((mel.shape[0], 1), arch.decoder_start_token_id, dtype=torch.long,
                             device=mel.device)
            enc_for_dec = out["encoder_last"]
            if compute_dtype is not None:
                enc_for_dec = enc_for_dec.to(compute_dtype)
            _, dec_layers, (dec_min, dec_mout) = decoder_forward(params, bos, enc_for_dec, arch,
                                                                 with_mlp=True)
            dec_layers = dec_layers.to(out_dt)
            if apply_layer_norm:
                dec = params["decoder"]
                dec_layers = _layer_norm(dec_layers, dec["ln_f_g"].float(), dec["ln_f_b"].float())
            out["decoder"] = dec_layers
            if with_mlp:
                out["decoder_mlp_in"] = dec_min.to(out_dt)
                out["decoder_mlp_out"] = dec_mout.to(out_dt)
    return out


def flatten_activations(acts: torch.Tensor, component: str = "encoder") -> torch.Tensor:
    """``[B, S, H]`` -> ``[B*S, H]`` row-major (``component`` is accepted
    for call-site parity; the reshape is the same for both)."""
    return acts.reshape(-1, acts.shape[-1])


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def decoder_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM logits from decoder hidden states (the output projection is tied
    to the token embedding), an f32 product of the operands as given."""
    return mm_f32(hidden, params["decoder"]["tok"].t())


def _forced_buffer(forced_ids, max_len: int) -> np.ndarray:
    """``[max_len]`` int32: the forced token id at positions
    1..len(forced_ids), -1 (unforced) elsewhere, as HF generate's
    ``forced_decoder_ids``."""
    buf = np.full((max_len,), -1, np.int32)
    if forced_ids:
        ids = list(forced_ids)[: max_len - 1]
        buf[1 : 1 + len(ids)] = ids
    return buf


@dataclass
class _DecodeState:
    """What a cached decode keeps across its steps: each layer's parameter
    views, the cross-attention keys (``[B, heads, hd, T_enc]``, widened to
    f32 once for the f32 scores) and values (``[B, heads, T_enc, hd]``),
    and the self-attention caches ``[L, B, max_len, D]``."""

    layers: list
    xk: list
    xv: list
    cache_k: torch.Tensor
    cache_v: torch.Tensor
    positions: torch.Tensor


def _decode_state(params: dict, arch: WhisperArch, enc: torch.Tensor,
                  max_len: int) -> _DecodeState:
    """Cross-attention K and V once per layer (``enc @ wk``, ``enc @ wv +
    bv``; not the few-query reassociation of ``_attention``, as the JAX
    cached decode) and zeroed caches in ``enc``'s dtype."""
    dec = params["decoder"]
    b, t_enc, d = enc.shape
    nh, hd = arch.num_heads, arch.head_dim
    layers = [_layer(dec["layers"], i) for i in range(_n_layers(dec["layers"]))]
    xk, xv = [], []
    for lp in layers:
        k = enc @ lp["xattn"]["wk"]
        v = enc @ lp["xattn"]["wv"] + lp["xattn"]["bv"]
        xk.append(k.reshape(b, t_enc, nh, hd).permute(0, 2, 3, 1).float().contiguous())
        xv.append(v.reshape(b, t_enc, nh, hd).transpose(1, 2).contiguous())
    cache = torch.zeros((len(layers), b, max_len, d), dtype=enc.dtype, device=enc.device)
    return _DecodeState(layers, xk, xv, cache, cache.clone(),
                        torch.arange(max_len, device=enc.device))


def _decode_step(params: dict, arch: WhisperArch, state: _DecodeState, tok: torch.Tensor,
                 t: int) -> torch.Tensor:
    """One cached decoder step at position ``t`` for the tokens ``tok``
    ``[B]``: writes the step's self-attention keys (no bias) and values
    into the caches at ``t`` and returns the next-token logits ``[B, V]``
    f32.  q is scaled in the compute dtype; scores and softmax are f32,
    positions past ``t`` masked; the softmax is cast to v's dtype before
    the value product."""
    dec = params["decoder"]
    b = tok.shape[0]
    nh, hd, d = arch.num_heads, arch.head_dim, arch.d_model
    max_len = state.cache_k.shape[2]

    def heads(y):  # [B, 1, D] -> [B, nh, 1, hd]
        return y.reshape(b, 1, nh, hd).transpose(1, 2)

    def merge(y):  # [B, nh, 1, hd] -> [B, 1, D]
        return y.transpose(1, 2).reshape(b, 1, d)

    future = state.positions > t
    x = dec["tok"][tok.long()][:, None, :] + dec["pos"][t]
    for i, lp in enumerate(state.layers):
        a = lp["attn"]
        hn = _layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        q = heads((hn @ a["wq"] + a["bq"]) * hd**-0.5)
        state.cache_k[i, :, t] = (hn @ a["wk"])[:, 0]
        state.cache_v[i, :, t] = (hn @ a["wv"] + a["bv"])[:, 0]
        ks = state.cache_k[i].reshape(b, max_len, nh, hd).transpose(1, 2)
        vs = state.cache_v[i].reshape(b, max_len, nh, hd).transpose(1, 2)
        s = torch.matmul(q.float(), ks.float().transpose(-1, -2))
        s = s.masked_fill(future, torch.finfo(torch.float32).min)
        w = torch.softmax(s, dim=-1).to(vs.dtype)
        x = x + merge(w @ vs) @ a["wo"] + a["bo"]
        c = lp["xattn"]
        hn = _layer_norm(x, lp["ln_x_g"], lp["ln_x_b"])
        q = heads((hn @ c["wq"] + c["bq"]) * hd**-0.5)
        w = torch.softmax(torch.matmul(q.float(), state.xk[i]), dim=-1).to(state.xv[i].dtype)
        x = x + merge(w @ state.xv[i]) @ c["wo"] + c["bo"]
        x = x + _mlp(_layer_norm(x, lp["ln2_g"], lp["ln2_b"]), lp["mlp"])
    x = _layer_norm(x, dec["ln_f_g"], dec["ln_f_b"])
    return decoder_logits(params, x[:, 0])


def _next_token(logits: torch.Tensor, forced_id: int, finished: torch.Tensor,
                eos: int) -> torch.Tensor:
    """The first maximum, then the forced id (``>= 0``), then the EOS
    freeze; marks the rows that emitted EOS in ``finished``."""
    nxt = logits.argmax(dim=-1)
    if forced_id >= 0:
        nxt = torch.full_like(nxt, forced_id)
    nxt = nxt.masked_fill(finished, eos)
    finished |= nxt == eos
    return nxt


@torch.no_grad()
def greedy_decode_cached(params: dict, mel: torch.Tensor | None, arch: WhisperArch,
                         max_len: int = 32, encoder_hidden: torch.Tensor | None = None,
                         forced_ids: tuple[int, ...] | None = None) -> torch.Tensor:
    """KV-cached greedy decoding: one incremental decoder step a token.

    The encoder runs only when ``encoder_hidden`` is None (bf16 weights
    and mel take the fused encoder kernels).  Cross-attention K/V are
    computed once; the self-attention caches are static ``[L, B,
    max_len, D]`` buffers written at each step.  Sequences freeze to
    ``arch.eos_token_id`` once they emit it; ``forced_ids`` pins the
    prompt positions 1..len(forced_ids).  Returns int32 ``[B, max_len]``
    starting with the decoder start token, on the encoder hidden's
    device (mel's, when the encoder runs here)."""
    with f32_matmuls():
        if encoder_hidden is None:
            encoder_hidden, _ = encoder_forward(params, mel, arch)
        state = _decode_state(params, arch, encoder_hidden, max_len)
        b = encoder_hidden.shape[0]
        tokens = torch.full((b, max_len), arch.decoder_start_token_id, dtype=torch.long,
                            device=encoder_hidden.device)
        finished = torch.zeros(b, dtype=torch.bool, device=encoder_hidden.device)
        forced = _forced_buffer(forced_ids, max_len)
        for t in range(max_len - 1):
            logits = _decode_step(params, arch, state, tokens[:, t], t)
            tokens[:, t + 1] = _next_token(logits, int(forced[t + 1]), finished,
                                           arch.eos_token_id)
    return tokens.to(torch.int32)


@torch.no_grad()
def greedy_decode(params: dict, mel: torch.Tensor | None, arch: WhisperArch, max_len: int = 32,
                  encoder_hidden: torch.Tensor | None = None,
                  forced_ids: tuple[int, ...] | None = None) -> torch.Tensor:
    """Greedy decoding without a cache: a full ``decoder_forward`` over the
    fixed-length buffer a step.  Same tokens, freeze and forcing as
    :func:`greedy_decode_cached`."""
    with f32_matmuls():
        if encoder_hidden is None:
            encoder_hidden, _ = encoder_forward(params, mel, arch)
        b = encoder_hidden.shape[0]
        tokens = torch.full((b, max_len), arch.decoder_start_token_id, dtype=torch.long,
                            device=encoder_hidden.device)
        finished = torch.zeros(b, dtype=torch.bool, device=encoder_hidden.device)
        forced = _forced_buffer(forced_ids, max_len)
        for t in range(max_len - 1):
            hidden, _ = decoder_forward(params, tokens, encoder_hidden, arch)
            tokens[:, t + 1] = _next_token(decoder_logits(params, hidden[:, t]),
                                           int(forced[t + 1]), finished, arch.eos_token_id)
    return tokens.to(torch.int32)


def transcribe(params: dict, arch: WhisperArch, audio, tokenizer=None, max_len: int = 224,
               forced_ids: tuple[int, ...] | None = None, device=None):
    """Audio ``[n]`` or ``[B, n]`` at 16 kHz -> token ids ``[B, max_len]``,
    or text when a tokenizer (anything with ``batch_decode``) is given.

    Log-mel, the encoder and the cached greedy decode on ``device`` (the
    card unless ``"cpu"`` is asked for; ``params`` must be there).  With
    a tokenizer and no ``forced_ids``, its ``get_decoder_prompt_ids``
    (sorted by position) is the forced prompt."""
    mel = log_mel_spectrogram(audio, n_mels=arch.n_mels, device=resolve_device(device))
    if forced_ids is None and tokenizer is not None:
        get_prompt = getattr(tokenizer, "get_decoder_prompt_ids", None)
        if get_prompt is not None:
            forced_ids = tuple(tok for _, tok in sorted(get_prompt()))
    tokens = greedy_decode_cached(params, mel, arch, max_len=max_len, forced_ids=forced_ids)
    if tokenizer is None:
        return tokens
    return tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)
