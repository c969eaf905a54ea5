"""Plain reference of Whisper's extraction forward, and the comparison of
a batch's captured layers with it.

The forward follows the published Whisper (HF ``transformers``'
``WhisperModel``): the stem Conv1d(k3, p1) GELU, Conv1d(k3, s2, p1)
GELU, plus the sinusoidal positions; pre-LN encoder layers (self
attention with q scaled by ``head_dim**-0.5``, k without a bias, exact
GELU MLP, LN eps 1e-5); then the decoder on one token, the BOS
(``decoder_start_token_id``): token and learned position embeddings,
causal self-attention, cross-attention over the encoder's final hidden
state, MLP.  The captures: each encoder layer's output under the
encoder's final LN, each decoder layer's output under the decoder's
final LN; the encoder's last capture is its final hidden state.

Precision, as the configuration states it (bf16 compute): activations
stored in bf16 between operations; products of operands rounded to the
compute precision (``lowp``), summed in f32 (TF32 off); biases added,
LN, softmax and GELU in f32 before the result is stored.  Clips are
taken a block at a time so that the scores fit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .lowp import ROUNDERS, true_f32

LN_EPS = 1e-5


def _store(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _ln(x, g, b):
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * g.float() + b.float()


class _Model:
    def __init__(self, params: dict, cfg: dict, precision: str):
        self.p, self.cfg = params, cfg
        self.rnd = ROUNDERS[precision]
        self.heads = cfg["encoder_attention_heads"]

    def mm(self, a, w):
        return torch.matmul(self.rnd(a), self.rnd(w.float()))

    def attention(self, xq, xkv, a: dict, i: int):
        """Multi-head attention of ``xq [b, tq, d]`` over ``xkv [b, tk, d]``
        with layer ``i`` of the stacked weights ``a`` (no mask: the one BOS
        query sees only itself, so the causal mask leaves nothing out)."""
        b, tq, d = xq.shape
        tk, h = xkv.shape[1], self.heads
        hd = d // h
        q = _store((self.mm(xq, a["wq"][i]) + a["bq"][i].float()) * hd ** -0.5)
        k = _store(self.mm(xkv, a["wk"][i]))
        v = _store(self.mm(xkv, a["wv"][i]) + a["bv"][i].float())
        q, k, v = (t.view(b, -1, h, hd).transpose(1, 2) for t in (q, k, v))
        probs = torch.softmax(self.mm(q, k.transpose(-1, -2)), dim=-1)
        o = _store(self.mm(probs, v)).transpose(1, 2).reshape(b, tq, d)
        return self.mm(o, a["wo"][i]) + a["bo"][i].float()

    def mlp(self, x, m: dict, i: int):
        hidden = _store(F.gelu(self.mm(x, m["w1"][i]) + m["b1"][i].float()))
        return self.mm(hidden, m["w2"][i]) + m["b2"][i].float()

    def encoder(self, mel):
        e = self.p["encoder"]
        x = F.conv1d(self.rnd(mel.float()), self.rnd(e["conv1_w"].float()), padding=1)
        x = _store(F.gelu(x + e["conv1_b"].float()[None, :, None]))
        x = F.conv1d(self.rnd(x), self.rnd(e["conv2_w"].float()), stride=2, padding=1)
        x = F.gelu(x + e["conv2_b"].float()[None, :, None]).transpose(1, 2)
        x = _store(x + e["pos"][:x.shape[1]].float())
        lay, caps = e["layers"], []
        for i in range(lay["ln1_g"].shape[0]):
            h = _store(_ln(x, lay["ln1_g"][i], lay["ln1_b"][i]))
            x = _store(x + self.attention(h, h, lay["attn"], i))
            m = _store(_ln(x, lay["ln2_g"][i], lay["ln2_b"][i]))
            x = _store(x + self.mlp(m, lay["mlp"], i))
            caps.append(_store(_ln(x, e["ln_f_g"], e["ln_f_b"])))
        return torch.stack(caps)

    def decoder(self, enc_last):
        dd = self.p["decoder"]
        b = enc_last.shape[0]
        bos = self.cfg["decoder_start_token_id"]
        x = _store(dd["tok"][bos].float() + dd["pos"][0].float()).expand(b, 1, -1)
        lay, caps = dd["layers"], []
        for i in range(lay["ln1_g"].shape[0]):
            h = _store(_ln(x, lay["ln1_g"][i], lay["ln1_b"][i]))
            x = _store(x + self.attention(h, h, lay["attn"], i))
            h = _store(_ln(x, lay["ln_x_g"][i], lay["ln_x_b"][i]))
            x = _store(x + self.attention(h, enc_last, lay["xattn"], i))
            m = _store(_ln(x, lay["ln2_g"][i], lay["ln2_b"][i]))
            x = _store(x + self.mlp(m, lay["mlp"], i))
            caps.append(_store(_ln(x, dd["ln_f_g"], dd["ln_f_b"])))
        return torch.stack(caps)


def _blocks(params: dict, cfg: dict, mel: torch.Tensor, precision: str, block: int):
    """The reference's captures, ``block`` clips at a time: (first clip,
    encoder ``[L_enc, block, t, d]``, decoder ``[L_dec, block, 1, d]``)."""
    ref = _Model(params, cfg, precision)
    with true_f32():
        for c0 in range(0, mel.shape[0], block):
            enc = ref.encoder(mel[c0:c0 + block])
            yield c0, enc, ref.decoder(enc[-1])


@torch.no_grad()
def compare(params: dict, cfg: dict, mel: torch.Tensor, encoder: torch.Tensor,
            decoder: torch.Tensor, block: int = 4) -> dict[str, float]:
    """The captures ``encoder [L_enc, b, t, d]`` and ``decoder [L_dec, b, 1,
    d]`` of the mels ``mel [b, n_mels, t_mel]`` against the reference's
    -> ``enc`` and ``dec``: the largest relative gap, ``|p - r| / |r|``
    over one clip's capture of one layer."""
    worst = {"enc": 0.0, "dec": 0.0}
    for c0, enc, dec in _blocks(params, cfg, mel, "bf16", block):
        for key, r, prog in (("enc", enc, encoder), ("dec", dec, decoder)):
            p = prog[:, c0:c0 + r.shape[1]].float()
            gap = (torch.linalg.vector_norm((p - r).flatten(2), dim=2)
                   / torch.linalg.vector_norm(r.flatten(2), dim=2))
            worst[key] = max(worst[key], float(gap.max()))
    return worst


@torch.no_grad()
def captures(params: dict, cfg: dict, mel: torch.Tensor, precision: str,
             block: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's own captures in bf16, for a control put in the
    program's place (``precision="fp8"``)."""
    encs, decs = [], []
    for _, enc, dec in _blocks(params, cfg, mel, precision, block):
        encs.append(enc.to(torch.bfloat16))
        decs.append(dec.to(torch.bfloat16))
    return torch.cat(encs, dim=1), torch.cat(decs, dim=1)
