"""The coder kernel timed alone on the card, for comparing two trees.

Times ``cuda_coder._coder_launch`` in each of its five modes at
whisper-tiny's width (Skip and TopK transcoder, ReLU SAE: D=384,
H=3072, k=32; TopK and ReLU crosscoder on the flattened view: L*D=1536,
S=3072) on 128, 4096 and 32768 rows of seeded gaussian data, sliced, over
20 launches (5 at 32768) between CUDA events after 3 warm ones, and at 128
rows the host's time to enqueue a call (the mean of 50 calls on the host
clock, none waiting for the card); then the wall time of a training step
(AMP, the windowed kernel) of a ReLU SAE at the CLI's batch 128 (3 epochs
of 200 steps) and of a ReLU crosscoder (L=4, S=3072), a TopK crosscoder
(L=4, S=3072, k=32) and a Skip transcoder (D=384, H=3072, k=32) at batch
4096 (an epoch of 20 steps) and 32768 (6), on the host clock after a warm
epoch.  The kernels are those of the package found on the import path,
built from its own sources, so the same command run with another tree's
``src`` first on ``PYTHONPATH`` times that tree: run the two in turns
(parent, change, change, parent) in one call to compare them on one card
(a tree whose ``cuda_coder.operands`` takes no ``topk`` builds W_dec in
both layouts).  Prints the card's name and power limit, then one JSON
line.  Needs one H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.coder_probe
"""

from __future__ import annotations

import inspect
import json
import tempfile
import time

import torch

from . import _build, _probe, cuda_coder
from ._probe import step_ms, time_ms
from ..config import SAEConfig, TrainingConfig
from ..models.crosscoder import create_crosscoder
from ..models.sae import create_sae
from ..models.transcoder import create_transcoder
from ..training.coder_trainers import CrosscoderTrainer, TranscoderTrainer
from ..training.trainer import SAETrainer

D, H, K = 384, 3072, 32
ROWS = (128, 4096, 32768)
MODES = {  # mode: (D, dout, k or None for ReLU, skip, y is x)
    "skip_transcoder": (D, D, K, True, False),
    "topk_transcoder": (D, D, K, False, False),
    "relu_sae": (D, D, None, False, True),
    "topk_crosscoder": (4 * D, 4 * D, K, False, True),
    "relu_crosscoder": (4 * D, 4 * D, None, False, True),
}


def _host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return, the card idle at
    the start and the launch queue never full."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("coder_probe: needs a CUDA device")
    dev = torch.device("cuda")
    card = _probe.card()
    print(card, flush=True)
    _build.load_library()
    res = {"card": card, "src": cuda_coder.__file__}
    one_layout = "topk" in inspect.signature(cuda_coder.operands).parameters
    for i, (mode, (d, dout, k, skip, y_is_x)) in enumerate(MODES.items()):
        g = torch.Generator(device=dev).manual_seed(i)

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=dev) * scale

        ops = cuda_coder.operands(randn(d, H, scale=d ** -0.5), randn(H, scale=0.05),
                                  randn(H, dout, scale=0.05), randn(dout, scale=0.05),
                                  randn(d, dout, scale=0.02) if skip else None,
                                  **({"topk": k is not None} if one_layout else {}))
        res[mode] = {}
        for rows in ROWS:
            x = randn(rows, d)
            y = None if y_is_x else randn(rows, dout)
            call = lambda: cuda_coder._coder_launch(x, y, 0, rows, ops, k)  # noqa: E731
            res[mode][str(rows)] = time_ms(call, iters=5 if rows > 4096 else 20)
            if rows == ROWS[0]:
                res[mode]["host_us_128"] = _host_us(call)
    g = torch.Generator(device=dev).manual_seed(99)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as runs:
        sae = create_sae(SAEConfig(activation="relu"), D, device=dev)
        cfg = TrainingConfig(batch_size=128, warmup_steps=10, use_amp=True)
        res["relu_sae_step_128"] = step_ms(SAETrainer(sae, cfg, run_dir=f"{runs}/sae"),
                                            torch.randn(200 * 128, D, generator=g, device=dev),
                                            200, epochs=3)
        for b, steps in ((4096, 20), (32768, 6)):
            cfg = TrainingConfig(batch_size=b, warmup_steps=10, use_amp=True)
            for name, topk in (("relu_crosscoder", False), ("topk_crosscoder", True)):
                xc = CrosscoderTrainer(create_crosscoder(D, 4, H, k=K, use_topk=topk, device=dev),
                                       cfg, run_dir=f"{runs}/{name}{b}")
                res[f"{name}_step_{b}"] = step_ms(
                    xc, torch.randn(steps * b, 4, D, generator=g, device=dev), steps)
                del xc
            tc = TranscoderTrainer(create_transcoder(D, D, H, k=K, use_skip=True, device=dev), cfg,
                                   run_dir=f"{runs}/tc{b}")
            res[f"skip_transcoder_step_{b}"] = step_ms(
                tc, (torch.randn(steps * b, D, generator=g, device=dev),
                     torch.randn(steps * b, D, generator=g, device=dev)), steps)
            del tc
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
