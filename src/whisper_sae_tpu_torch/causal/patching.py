"""Causal interventions: activation patching through the Whisper forward
(counterpart of ``whisper_sae_tpu/causal/patching.py``).

An intervention is a function applied to one layer's output inside the
composed forward (``models/whisper.py``: the composed stem,
``_encoder_layer``, ``_decoder_layer``, ``decoder_logits``), in f32 with
TF32 off throughout: the stem's ``F.conv1d`` would otherwise take TF32 in
cuDNN, and the logits would leave the f32 bars.

Provided interventions: an arbitrary ``patch_fn`` on any encoder or
decoder layer's output; SAE substitution (the layer's activations
replaced by their SAE reconstruction, a final-LN-space SAE mapped back
with the inverse affine and the original activations' mean and
population variance); SAE feature ablation and steering.  A TopK SAE's
f32 encode is ``models/sae.py:topk_hidden_f32``: on the card kernel B
writing f32, as the TPU's Pallas encode does in JAX's patches.

Effect metrics: mean KL of the LM logits under the patch and greedy-token
agreement.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..models.sae import relu_sae_apply, topk_hidden_f32
from ..models.whisper import (
    LN_EPS,
    WhisperArch,
    _decoder_layer,
    _encoder_layer,
    _layer,
    _layer_norm,
    _n_layers,
    _next_token,
    composed_stem,
    decoder_forward,
    decoder_logits,
    encoder_forward,
    greedy_decode_cached,
)
from ..utils.device import f32_matmuls


@torch.no_grad()
def encoder_forward_patched(
    params: dict,
    mel: torch.Tensor,
    arch: WhisperArch,
    layer_idx: int,
    patch_fn: Callable[[torch.Tensor], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder forward with ``patch_fn`` applied to layer ``layer_idx``'s
    output (shape-preserving ``[B, T, D] -> [B, T, D]``).

    Returns (last hidden after the final LN, per-layer outputs ``[L, B,
    T, D]`` downstream of the patch).
    """
    enc = params["encoder"]
    with f32_matmuls():
        x = composed_stem(mel, enc)
        outs = []
        for i in range(_n_layers(enc["layers"])):
            x, _, _ = _encoder_layer(x, _layer(enc["layers"], i), arch.num_heads)
            if i == layer_idx:
                x = patch_fn(x)
            outs.append(x)
        last = _layer_norm(x, enc["ln_f_g"], enc["ln_f_b"])
    return last, torch.stack(outs)


@torch.no_grad()
def decoder_forward_patched(
    params: dict,
    token_ids: torch.Tensor,
    enc_hidden: torch.Tensor,
    arch: WhisperArch,
    layer_idx: int,
    patch_fn: Callable[[torch.Tensor], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoder forward with ``patch_fn`` applied to decoder layer
    ``layer_idx``'s output (for decoder-side SAE validation)."""
    dec = params["decoder"]
    t = token_ids.shape[1]
    with f32_matmuls():
        x = dec["tok"][token_ids] + dec["pos"][:t]
        enc_hidden = enc_hidden.to(x.dtype)
        outs = []
        for i in range(_n_layers(dec["layers"])):
            x, _, _ = _decoder_layer(x, enc_hidden, _layer(dec["layers"], i), arch.num_heads)
            if i == layer_idx:
                x = patch_fn(x)
            outs.append(x)
        last = _layer_norm(x, dec["ln_f_g"], dec["ln_f_b"])
    return last, torch.stack(outs)


def _pure_reconstruct(sae, x: torch.Tensor) -> torch.Tensor:
    """SAE reconstruction without the facade's ``forward``, which updates
    the dead-feature counters in training mode: known facades go through
    the functional forwards on ``sae.params``; other callables through
    ``sae(x)``."""
    params = getattr(sae, "params", None)
    if params is not None and hasattr(sae, "k"):  # topk_sae_apply's f32 reconstruction
        hidden = topk_hidden_f32(params, x, sae.k)
        with f32_matmuls():
            return torch.matmul(hidden, params["w_dec"]) + params["b_dec"] + params["b_pre"]
    if params is not None and hasattr(sae, "sparsity_weight"):
        out, _ = relu_sae_apply(params, x, sae.sparsity_weight)
        return out.reconstructed
    return sae(x).reconstructed


def _ln_space(whisper_params: dict, component: str, apply_layer_norm: bool):
    """(to_sae, from_sae) for a layer's ``[N, D]`` rows: into the final-LN
    space with the rows' own mean and population variance, and back with
    the inverse affine; identities without ``apply_layer_norm``."""
    g = whisper_params[component]["ln_f_g"]
    b = whisper_params[component]["ln_f_b"]

    def to_sae(flat):
        if not apply_layer_norm:
            return flat, None
        mean = flat.mean(dim=-1, keepdim=True)
        var = flat.var(dim=-1, keepdim=True, correction=0)
        return (flat - mean) * torch.rsqrt(var + LN_EPS) * g + b, (mean, var)

    def from_sae(recon, stats):
        if stats is None:
            return recon
        mean, var = stats
        return (recon - b) / g * torch.sqrt(var + LN_EPS) + mean

    return to_sae, from_sae


def sae_reconstruction_patch(
    sae,
    whisper_params: dict,
    apply_layer_norm: bool = True,
    component: str = "encoder",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Patch a layer's output with its SAE reconstruction.

    An SAE trained on final-LN-applied activations reconstructs in LN
    space; the reconstruction is mapped back with the inverse affine and
    the original activations' per-token mean and variance.  ``component``
    selects whose final layer norm defines that space."""
    to_sae, from_sae = _ln_space(whisper_params, component, apply_layer_norm)

    def patch(h: torch.Tensor) -> torch.Tensor:
        shape = h.shape
        x, stats = to_sae(h.reshape(-1, shape[-1]))
        return from_sae(_pure_reconstruct(sae, x), stats).reshape(shape)

    return patch


def feature_steering_patch(
    sae,
    feature_idxs,
    whisper_params: dict,
    scale: float | None = None,
    set_value: float | None = None,
    apply_layer_norm: bool = True,
    component: str = "encoder",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Steer selected SAE latents and substitute the resulting
    reconstruction for the layer's output: ``scale`` multiplies them
    (``scale=0`` is ablation), ``set_value`` clamps them to a constant.
    Exactly one of the two must be given."""
    if (scale is None) == (set_value is None):
        raise ValueError("give exactly one of scale= or set_value=")
    to_sae, from_sae = _ln_space(whisper_params, component, apply_layer_norm)
    idx = torch.as_tensor(feature_idxs, dtype=torch.int64)

    def patch(h: torch.Tensor) -> torch.Tensor:
        shape = h.shape
        x, stats = to_sae(h.reshape(-1, shape[-1]))
        hidden = sae.encode(x).clone()
        cols = idx.to(hidden.device)
        if scale is not None:
            hidden[:, cols] = hidden[:, cols] * scale
        else:
            hidden[:, cols] = set_value
        return from_sae(sae.decode(hidden), stats).reshape(shape)

    return patch


def feature_ablation_patch(
    sae,
    feature_idxs,
    whisper_params: dict,
    apply_layer_norm: bool = True,
    component: str = "encoder",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Replace a layer's output with the SAE reconstruction computed with
    the given latents zeroed (causal feature ablation)."""
    return feature_steering_patch(sae, feature_idxs, whisper_params, set_value=0.0,
                                  apply_layer_norm=apply_layer_norm, component=component)


# ---------------------------------------------------------------------------
# effect metrics
# ---------------------------------------------------------------------------


def _bos(arch: WhisperArch, b: int, device) -> torch.Tensor:
    return torch.full((b, 1), arch.decoder_start_token_id, dtype=torch.long, device=device)


@torch.no_grad()
def patched_logits(params: dict, mel: torch.Tensor, arch: WhisperArch, layer_idx: int,
                   patch_fn) -> torch.Tensor:
    """LM logits for the BOS step under a patched encoder."""
    enc_last, _ = encoder_forward_patched(params, mel, arch, layer_idx, patch_fn)
    with f32_matmuls():
        hidden, _ = decoder_forward(params, _bos(arch, mel.shape[0], mel.device), enc_last, arch)
        return decoder_logits(params, hidden[:, 0, :])


def _clean_encoder(params: dict, mel: torch.Tensor, arch: WhisperArch) -> torch.Tensor:
    with torch.no_grad(), f32_matmuls():
        return encoder_forward(params, mel, arch)[0]


@torch.no_grad()
def patched_logits_decoder(
    params: dict,
    mel: torch.Tensor,
    arch: WhisperArch,
    layer_idx: int,
    patch_fn,
    encoder_hidden: torch.Tensor | None = None,
) -> torch.Tensor:
    """LM logits for the BOS step with ``patch_fn`` applied to decoder
    layer ``layer_idx`` (the encoder runs clean)."""
    if encoder_hidden is None:
        encoder_hidden = _clean_encoder(params, mel, arch)
    hidden, _ = decoder_forward_patched(params, _bos(arch, encoder_hidden.shape[0],
                                                     encoder_hidden.device),
                                        encoder_hidden, arch, layer_idx, patch_fn)
    with f32_matmuls():
        return decoder_logits(params, hidden[:, 0, :])


@torch.no_grad()
def greedy_decode_patched_decoder(
    params: dict,
    mel: torch.Tensor,
    arch: WhisperArch,
    layer_idx: int,
    patch_fn,
    max_len: int = 16,
    encoder_hidden: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy decode with ``patch_fn`` live on decoder layer ``layer_idx``
    at every step: no KV cache, a full decoder forward over the
    fixed-length buffer a step, so the patch sees the whole prefix
    (analysis scale only).  Returns int32 ``[B, max_len]``."""
    if encoder_hidden is None:
        encoder_hidden = _clean_encoder(params, mel, arch)
    b = encoder_hidden.shape[0]
    tokens = torch.full((b, max_len), arch.decoder_start_token_id, dtype=torch.long,
                        device=encoder_hidden.device)
    finished = torch.zeros(b, dtype=torch.bool, device=encoder_hidden.device)
    for t in range(max_len - 1):
        hidden, _ = decoder_forward_patched(params, tokens, encoder_hidden, arch, layer_idx,
                                            patch_fn)
        with f32_matmuls():
            logits = decoder_logits(params, hidden[:, t, :])
        tokens[:, t + 1] = _next_token(logits, -1, finished, arch.eos_token_id)
    return tokens.to(torch.int32)


def logit_kl(clean_logits: torch.Tensor, patched: torch.Tensor) -> torch.Tensor:
    """Mean KL(clean || patched) over the batch."""
    p = torch.log_softmax(clean_logits, dim=-1)
    q = torch.log_softmax(patched, dim=-1)
    return torch.mean(torch.sum(torch.exp(p) * (p - q), dim=-1))


def token_agreement(tokens_a: torch.Tensor, tokens_b: torch.Tensor) -> torch.Tensor:
    """Fraction of greedy-decoded tokens that agree: the count times the
    f32 reciprocal of the number of tokens, the product XLA makes of the
    JAX package's mean (a division would differ in the last bit)."""
    agree = (tokens_a == tokens_b).to(torch.float32)
    return agree.sum() * torch.tensor(1.0 / agree.numel(), dtype=torch.float32,
                                      device=agree.device)


def substitution_effect(
    params: dict,
    mel: torch.Tensor,
    arch: WhisperArch,
    sae,
    layer_idx: int,
    apply_layer_norm: bool = True,
    max_len: int = 16,
    component: str = "encoder",
) -> dict[str, float]:
    """End-to-end causal validation of an SAE: substitute the layer's
    activations with the SAE reconstruction and measure the downstream
    effect on logits and greedy decodes.

    ``encoder`` patches encoder layer ``layer_idx`` (the patched last
    hidden state then feeds a clean cached decode); ``decoder`` patches
    decoder layer ``layer_idx`` live at every step of an uncached decode
    (the encoder runs clean)."""
    patch = sae_reconstruction_patch(sae, params, apply_layer_norm, component=component)
    clean_tokens = greedy_decode_cached(params, mel, arch, max_len=max_len)
    if component == "decoder":
        enc_last = _clean_encoder(params, mel, arch)
        clean = patched_logits_decoder(params, mel, arch, layer_idx, lambda h: h,
                                       encoder_hidden=enc_last)
        subbed = patched_logits_decoder(params, mel, arch, layer_idx, patch,
                                        encoder_hidden=enc_last)
        patched_tokens = greedy_decode_patched_decoder(params, mel, arch, layer_idx, patch,
                                                       max_len=max_len, encoder_hidden=enc_last)
    else:
        clean = patched_logits(params, mel, arch, layer_idx, lambda h: h)
        subbed = patched_logits(params, mel, arch, layer_idx, patch)
        enc_last, _ = encoder_forward_patched(params, mel, arch, layer_idx, patch)
        patched_tokens = greedy_decode_cached(params, mel, arch, max_len=max_len,
                                              encoder_hidden=enc_last)
    return {
        "logit_kl": float(logit_kl(clean, subbed)),
        "token_agreement": float(token_agreement(clean_tokens, patched_tokens)),
    }


def feature_ablation_sweep(
    params: dict,
    mel: torch.Tensor,
    arch: WhisperArch,
    sae,
    layer_idx: int,
    feature_indices,
    apply_layer_norm: bool = True,
    component: str = "encoder",
) -> list[dict[str, float]]:
    """Causal importance ranking: ablate each feature in turn (its latent
    zeroed inside the SAE substitution) and measure the logit KL beyond
    the substitution's own.  One record per feature, sorted by
    ``marginal_logit_kl`` descending."""
    if component == "decoder":
        logits_fn = partial(patched_logits_decoder,
                            encoder_hidden=_clean_encoder(params, mel, arch))
    else:
        logits_fn = patched_logits
    clean = logits_fn(params, mel, arch, layer_idx, lambda h: h)
    base_patch = sae_reconstruction_patch(sae, params, apply_layer_norm, component=component)
    base_kl = float(logit_kl(clean, logits_fn(params, mel, arch, layer_idx, base_patch)))

    out = []
    for fi in feature_indices:
        patch = feature_ablation_patch(sae, [int(fi)], params, apply_layer_norm,
                                       component=component)
        kl = float(logit_kl(clean, logits_fn(params, mel, arch, layer_idx, patch)))
        out.append({
            "feature_idx": int(fi),
            "logit_kl": kl,
            "marginal_logit_kl": kl - base_kl,
        })
    out.sort(key=lambda r: r["marginal_logit_kl"], reverse=True)
    return out
