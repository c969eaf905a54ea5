"""Whisper's work on ``b`` clips of ``t_mel`` mel frames (``t = t_mel / 2``
encoder positions), from the published layer equations.

``encoder_*``: the required work of the encoder forward with every
layer captured.  Tensor-core FLOPs: the stem's two convolutions
(``2·t_mel·3·n_mels·d`` and ``2·t·3·d·d``) and, each layer at ``t``,
q/k/v ``2·t·d·3d``, the scores and the weighted sum ``2·2·t·t·d``, the
out-projection ``2·t·d·d``, fc1 and fc2 ``2·2·t·d·f``.  ALU operations:
one exponential a score (``heads·t·t`` a layer), counted at the f32 peak
(the hardware's exponential is slower, so this bounds from below).
Bytes: every weight read once in bf16, the bf16 mels read once, each
layer's bf16 capture ``[b, t, d]`` written once.

``decoder_token_flops``: the decoder's one token (the BOS), each layer:
self-attention's q/k/v/out ``4·2·d·d`` and its core over one key,
cross-attention's q and out ``2·2·d·d``, its K and V over the ``t``
encoder frames ``2·2·t·d·d`` and its core ``2·2·t·d``, the MLP
``2·2·d·f``.  This is the standard algorithm's count, whatever route
the program takes.

``extract_model_flops``: the encoder's tensor-core FLOPs plus the
decoder's token: the model FLOPs of one ``extract_activations`` batch.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import peaks


@dataclass(frozen=True)
class Geometry:
    d: int
    ffn: int
    heads: int
    enc_layers: int
    dec_layers: int
    n_mels: int
    t_mel: int

    @property
    def t(self) -> int:
        return self.t_mel // 2

    @classmethod
    def of(cls, cfg: dict, t_mel: int) -> Geometry:
        return cls(cfg["d_model"], cfg["encoder_ffn_dim"], cfg["encoder_attention_heads"],
                   cfg["encoder_layers"], cfg["decoder_layers"], cfg["num_mel_bins"], t_mel)


def encoder_flops(b: int, g: Geometry) -> int:
    d, f, t = g.d, g.ffn, g.t
    stem = 2 * g.t_mel * 3 * g.n_mels * d + 2 * t * 3 * d * d
    layer = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d + 2 * 2 * t * d * f
    return b * (stem + g.enc_layers * layer)


def encoder_alu_ops(b: int, g: Geometry) -> int:
    return b * g.enc_layers * g.heads * g.t * g.t


def encoder_weight_count(g: Geometry) -> int:
    d, f = g.d, g.ffn
    stem = 3 * g.n_mels * d + d + 3 * d * d + d + g.t * d
    layer = 4 * d * d + 3 * d + 2 * d * f + f + d + 4 * d  # attention, MLP, two LNs
    return stem + g.enc_layers * layer + 2 * d


def encoder_bytes(b: int, g: Geometry) -> int:
    return 2 * (encoder_weight_count(g) + b * g.n_mels * g.t_mel + g.enc_layers * b * g.t * g.d)


def encoder_least_s(b: int, g: Geometry) -> float:
    return peaks.least_s(encoder_flops(b, g), encoder_alu_ops(b, g), encoder_bytes(b, g))


def decoder_token_flops(b: int, g: Geometry) -> int:
    d, f, t = g.d, g.ffn, g.t
    layer = (4 * 2 * d * d + 2 * 2 * d + 2 * 2 * d * d + 2 * 2 * t * d * d + 2 * 2 * t * d
             + 2 * 2 * d * f)
    return b * g.dec_layers * layer


def extract_model_flops(b: int, g: Geometry) -> int:
    return encoder_flops(b, g) + decoder_token_flops(b, g)
