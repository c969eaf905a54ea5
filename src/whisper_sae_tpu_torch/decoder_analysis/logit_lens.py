"""Logit lens over the Whisper decoder stack (counterpart of
``whisper_sae_tpu/decoder_analysis/logit_lens.py``).

Every decoder layer's hidden state at one position goes through the
final layer norm (in f32) and the tied token embedding
(``models.whisper.decoder_logits``): how the next-token prediction forms
layer by layer.  The last layer's lens is the model's own logits.
"""

from __future__ import annotations

import torch

from ..models.whisper import (
    WhisperArch,
    _layer_norm,
    decoder_forward,
    decoder_logits,
    encoder_forward,
)
from ..utils.device import f32_matmuls


@torch.no_grad()
def logit_lens(params: dict, mel: torch.Tensor, arch: WhisperArch,
               token_ids: torch.Tensor | None = None, top: int = 5,
               position: int = -1) -> dict[str, torch.Tensor]:
    """Per-layer next-token predictions at one decoder position.

    ``token_ids`` ``[B, T_dec]`` is the decoder prompt (default: the start
    token); ``position`` the position read (default: the last).  Returns
    ``token_ids`` ``[L_dec, B, top]`` int32 (each layer's top tokens),
    ``probs`` ``[L_dec, B, top]`` f32 (their softmax probabilities) and
    ``logits_last`` ``[B, V]`` f32 (the final layer's logits)."""
    with f32_matmuls():
        enc_hidden, _ = encoder_forward(params, mel, arch)
        if token_ids is None:
            token_ids = torch.full((mel.shape[0], 1), arch.decoder_start_token_id,
                                   dtype=torch.long, device=mel.device)
        _, layer_outs = decoder_forward(params, token_ids, enc_hidden, arch)
        dec = params["decoder"]
        lensed = _layer_norm(layer_outs[:, :, position, :].float(), dec["ln_f_g"].float(),
                             dec["ln_f_b"].float())
        logits = decoder_logits(params, lensed)  # [L, B, V]
        top_p, top_ids = torch.topk(torch.softmax(logits, dim=-1), top, dim=-1)
    return {"token_ids": top_ids.to(torch.int32), "probs": top_p, "logits_last": logits[-1]}


def lens_agreement(result: dict[str, torch.Tensor]) -> torch.Tensor:
    """``[L_dec]``: the share of batch items whose top-1 token at a layer
    is already the final layer's top-1."""
    ids = result["token_ids"][:, :, 0]
    return (ids == ids[-1][None, :]).float().mean(dim=1)
