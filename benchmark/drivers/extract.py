"""The extraction mix: ``models.whisper.extract_activations`` on seeded
mel batches, every encoder and decoder layer captured, the decoder on,
bf16 compute and captures (the extraction driver's fast mode).

The mix's file gives ``batch`` (clips), ``pool`` (distinct batches,
cycled), ``mel_frames``, ``mel_scale``, ``warm_batches``,
``trace_seconds`` and ``reference_block`` (the clips the reference
takes at a time); the configuration gives Whisper's sizes.  The weights
are made once, in bf16, the type extraction serves them in (the
extraction driver casts its tree once, not per batch).  Nothing leaves
the card: each batch's captures are dropped but for two that the check
keeps, the batch at a window position drawn from the seed and the
window's last, which it compares with the plain reference
(``reference/whisper_extract``) layer by layer, clip by clip, once the
window has closed.
"""

from __future__ import annotations

import torch

from harness import seeds
from inputs import whisper as inputs
from reference import whisper_extract as ref


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.b, self.pool = traffic["batch"], traffic["pool"]
        self.sample_at = seeds.derive(seed, "extract.sample") % self.pool
        self.attempted = self.failed = 0
        self.kept: dict[int, tuple] = {}

    def setup(self) -> None:
        self.build()
        for _ in range(self.traffic["warm_batches"]):
            self.unit()
        self.sync()
        self.attempted, self.kept = 0, {}

    def build(self) -> None:
        from whisper_sae_tpu_torch.models import whisper

        c = self.cfg
        self.whisper = whisper
        self.arch = whisper.WhisperArch(
            d_model=c["d_model"], encoder_layers=c["encoder_layers"],
            decoder_layers=c["decoder_layers"], num_heads=c["encoder_attention_heads"],
            ffn_dim=c["encoder_ffn_dim"], n_mels=c["num_mel_bins"],
            max_source_positions=c["max_source_positions"],
            max_target_positions=c["max_target_positions"], vocab_size=c["vocab_size"],
            decoder_start_token_id=c["decoder_start_token_id"], eos_token_id=c["eos_token_id"])
        self.params = inputs.params(c, self.seed, self.device)
        self.mels = inputs.mels(c, self.pool, self.b, self.traffic["mel_frames"],
                                self.traffic["mel_scale"], self.seed, self.device)

    def unit(self) -> int:
        i = self.attempted
        acts = self.whisper.extract_activations(
            self.params, self.mels[i % self.pool], self.arch, apply_layer_norm=True,
            with_decoder=True, compute_dtype=torch.bfloat16, capture_dtype=torch.bfloat16)
        out = (i % self.pool, acts["encoder"], acts["decoder"])
        self.kept = {k: v for k, v in self.kept.items() if k == self.sample_at}
        self.kept[i] = out
        self.attempted += 1
        return self.b

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spans(self) -> list:
        return [(self.whisper, "encoder_forward", "whisper.encoder"),
                (self.whisper, "decoder_forward", "whisper.decoder")]

    def route(self) -> dict[str, int]:
        """Launch counts of the encoder's kernels in this process: the route taken."""
        from whisper_sae_tpu_torch.ops import cuda_encoder, encoder

        fns = (cuda_encoder.conv_stem_fwd, cuda_encoder.ln_qkv_fwd,
               cuda_encoder.self_attention_fwd, cuda_encoder.out_proj_fwd,
               cuda_encoder.mlp_block_fwd)
        return {**{f.__name__: f.launches for f in fns}, "plain": sum(encoder.plain_calls.values())}

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict[str, float]:
        worst = {"enc": 0.0, "dec": 0.0}
        for j, enc, dec in self.kept.values():
            gaps = ref.compare(self.params, self.cfg, self.mels[j], enc, dec,
                               block=self.traffic["reference_block"])
            worst = {k: max(v, gaps[k]) for k, v in worst.items()}
        return worst


def readings(drv: Driver) -> dict:
    """The readings that set this kind's limits (``calibrate.py``), for one
    seed at the cell's sizes: ``program``, an extraction batch through the
    timed call against the reference; ``control``, the reference in fp8
    in the program's place; ``answer``, one clip's captures swapped with
    another's."""
    drv.build()
    drv.unit()
    drv.sync()
    (j, enc, dec), = drv.kept.values()
    mel, block = drv.mels[j], drv.traffic["reference_block"]
    out = {"program": drv.check()}
    enc8, dec8 = ref.captures(drv.params, drv.cfg, mel, "fp8", block)
    out["control"] = ref.compare(drv.params, drv.cfg, mel, enc8, dec8, block=block)
    swapped = enc.clone()
    swapped[:, [0, 1]] = enc[:, [1, 0]]
    out["answer"] = ref.compare(drv.params, drv.cfg, mel, swapped, dec, block=block)
    return out
