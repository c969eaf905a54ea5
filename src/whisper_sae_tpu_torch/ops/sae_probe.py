"""Kernels A, B and C and the blocked encode timed alone on the card, for
comparing two trees.

Times ``cuda_sae._fused_loss_launch`` (kernel A, sliced), kernel B's
``_topk_encode_launch`` (bf16 latent) and kernel C's ``topk_mask_fwd`` at
whisper-tiny's width (D=384, H=3072, k=32) on 128, 4096 and 32768 rows of
seeded gaussian data, each over 20 launches between CUDA events after 3
warm ones, and kernel B's device ms a call by kernel under
``torch.profiler`` (``fused_topk_encode_split``); then kernel A's wide
route at whisper-small 8x (D=768, H=6144, k=32; 128, 4096 and 32768 rows)
in turns with the composed route it replaces there (``topk_sae_apply``'s
bf16 forward: the top-k encode, the ``mm_f32`` decode, the loss):
composed / wide / wide / composed, and each of the wide route's launches'
device ms (``fused_sae_loss_wide_split``); then, at whisper-large 32x (D=1280, H=40960, k=32, 8192 rows),
the blocked encode (``_topk_encode_launch``, bf16 latent; a tree whose
blocked encode has its own entry, ``_blocked_encode_launch``) and kernel
C's wide form (``topk_mask_fwd`` on an f32 [8192, 40960] pre) over 10
launches after 2 warm ones, and the wall time of a TopK-SAE training step
there (AMP, batch 8192, 2 epochs of 3 steps after a warm one).  The
kernels are those of the package found on the import
path, built from its own sources, so the same command run with another
tree's ``src`` first on ``PYTHONPATH`` times that tree: run the two in
turns (parent, change, change, parent) in one call to compare them on
one card.  With ``--widths`` it times instead only the selects past H =
40960 at ``chip_smoke.py`` phase 23's shapes: kernel C
(``topk_mask_fwd``, f32) at [4096, 49152], [1024, 81920] and [64,
262144], and the top-k encode (``_topk_encode_launch``, bf16 latent) at
whisper-tiny 128x (kernel B, D=384, H=49152, 4096 rows), whisper-large
64x (the blocked encode, D=1280, H=81920, 4096 rows) and its widest row
(D=64, H=2^20, 512 rows in chunks of 80), each encode's launches' device
ms under ``torch.profiler`` (``select``: the select kernel's, whatever its
name).  Prints the card's name and power limit, then one JSON line.
Needs one H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.sae_probe [--widths]
"""

from __future__ import annotations

import json
import sys
import tempfile

import torch

from . import _build, _probe, cuda_sae, cuda_topk
from ._probe import device_split, step_ms, time_ms
from ..config import SAEConfig, TrainingConfig
from ..models.sae import create_sae, topk_sae_apply
from ..training.trainer import SAETrainer

D, H, K = 384, 3072, 32
ROWS = (128, 4096, 32768)
DS, HS = 768, 6144  # whisper-small 8x: kernel A's wide route
DL, HL, BL = 1280, 40960, 8192  # whisper-large 32x at bench.py's batch
LARGE_STEPS = 3
WIDTHS_MASK = ((4096, 49152), (1024, 81920), (64, 262144))
# (D, H, rows): whisper-tiny 128x, whisper-large 64x, the encode's widest row
WIDTHS_ENCODE = ((384, 49152, 4096), (1280, 81920, 4096), (64, 1 << 20, 512))


def widths(dev, res: dict) -> None:
    """The selects past H = 40960 at phase 23's shapes (``--widths``)."""
    g = torch.Generator(device=dev).manual_seed(3)
    for rows, h in WIDTHS_MASK:
        pre = torch.randn(rows, h, generator=g, device=dev)
        res[f"topk_mask_{rows}x{h}"] = time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K), iters=10,
                                               warmup=2)
        del pre
    for d, h, rows in WIDTHS_ENCODE:
        w_enc = torch.randn(d, h, generator=g, device=dev) * 0.05
        b_enc, b_pre = (torch.randn(h, generator=g, device=dev) * 0.05,
                        torch.randn(d, generator=g, device=dev) * 0.05)
        x = torch.randn(rows, d, generator=g, device=dev)
        we_t = cuda_sae._bf16_t(w_enc)
        encode = lambda: cuda_sae._topk_encode_launch(x, we_t, b_enc, b_pre, K,  # noqa: E731
                                                      torch.bfloat16)
        split = device_split(encode, calls=5)
        res[f"topk_encode_{d}x{h}"] = {
            "ms": time_ms(encode, iters=10, warmup=2), "split_ms": split,
            "select": sum(v for k_, v in split.items() if "select" in k_)}
        del w_enc, we_t, x


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sae_probe: needs a CUDA device")
    dev = torch.device("cuda")
    card = _probe.card()
    print(card, flush=True)
    _build.load_library()
    if "--widths" in sys.argv[1:]:
        res = {"card": card, "src": cuda_sae.__file__}
        widths(dev, res)
        print(json.dumps(res), flush=True)
        return
    g = torch.Generator().manual_seed(0)
    w_enc, b_enc, b_pre = (torch.randn(D, H, generator=g) * 0.05, torch.randn(H, generator=g) * 0.05,
                           torch.randn(D, generator=g) * 0.05)
    w_dec, b_dec = torch.randn(H, D, generator=g) * 0.05, torch.randn(D, generator=g) * 0.05
    w_enc, b_enc, b_pre, w_dec, b_dec = (t.to(dev) for t in (w_enc, b_enc, b_pre, w_dec, b_dec))
    we_t, wd, b_out = cuda_sae._bf16_t(w_enc), w_dec.bfloat16(), b_dec + b_pre
    res = {"card": card, "src": cuda_sae.__file__}
    for rows in ROWS:
        x = torch.randn(rows, D, generator=g).to(dev)
        pre = (torch.randn(rows, H, generator=g)).to(dev)
        encode = lambda: cuda_sae._topk_encode_launch(x, we_t, b_enc, b_pre, K,  # noqa: E731
                                                      torch.bfloat16)
        res[str(rows)] = {
            "fused_sae_loss": time_ms(lambda: cuda_sae._fused_loss_launch(
                x, 0, rows, we_t, b_enc, b_pre, wd, b_out, K)),
            "fused_topk_encode": time_ms(encode),
            "topk_mask": time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K)),
            "fused_topk_encode_split": device_split(encode),
        }
    del x, pre

    gs = torch.Generator(device=dev).manual_seed(2)
    ps = {"w_enc": torch.randn(DS, HS, generator=gs, device=dev) * 0.05,
          "b_enc": torch.randn(HS, generator=gs, device=dev) * 0.05,
          "b_pre": torch.randn(DS, generator=gs, device=dev) * 0.05,
          "w_dec": torch.randn(HS, DS, generator=gs, device=dev) * 0.05,
          "b_dec": torch.randn(DS, generator=gs, device=dev) * 0.05}
    we_t, wd, b_out = cuda_sae._bf16_t(ps["w_enc"]), ps["w_dec"].bfloat16(), ps["b_dec"] + ps["b_pre"]
    for rows in ROWS:
        x = torch.randn(rows, DS, generator=gs, device=dev)
        wide = lambda: cuda_sae._fused_loss_launch(  # noqa: E731
            x, 0, rows, we_t, ps["b_enc"], ps["b_pre"], wd, b_out, K, True)
        with torch.no_grad():
            composed = lambda: topk_sae_apply(ps, x, K, torch.bfloat16)  # noqa: E731
            turns = [time_ms(f) for f in (composed, wide, wide, composed)]
        res[f"whisper_small_8x_{rows}"] = {
            "composed_wide_wide_composed": turns,
            "fused_sae_loss_wide_split": device_split(wide),
        }
    del x

    gl = torch.Generator(device=dev).manual_seed(1)
    w_enc = torch.randn(DL, HL, generator=gl, device=dev) * 0.05
    b_enc, b_pre = (torch.randn(HL, generator=gl, device=dev) * 0.05,
                    torch.randn(DL, generator=gl, device=dev) * 0.05)
    x = torch.randn(BL, DL, generator=gl, device=dev)
    we_t = cuda_sae._bf16_t(w_enc)
    pre = (torch.matmul((x - b_pre).bfloat16().float(), w_enc.bfloat16().float()) + b_enc)
    blocked = getattr(cuda_sae, "_blocked_encode_launch", cuda_sae._topk_encode_launch)
    res[f"whisper_large_32x_{BL}"] = {
        "fused_topk_encode_blocked": time_ms(lambda: blocked(
            x, we_t, b_enc, b_pre, K, torch.bfloat16), iters=10, warmup=2),
        "topk_mask_wide": time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K), iters=10, warmup=2),
    }
    del w_enc, we_t, x, pre
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as runs:
        sae = create_sae(SAEConfig(expansion_factor=HL // DL, k=K), DL, device=dev)
        cfg = TrainingConfig(batch_size=BL, warmup_steps=2, use_amp=True)
        rows = torch.randn(LARGE_STEPS * BL, DL, generator=gl, device=dev)
        res[f"whisper_large_32x_{BL}"]["step"] = step_ms(
            SAETrainer(sae, cfg, run_dir=f"{runs}/large"), rows, LARGE_STEPS, epochs=2)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
