#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/whisper_sae_tpu_torch``) on one
NVIDIA GPU (built for the H100, ``sm_90a``).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

0. Build: compile the port's CUDA kernels from ``ops/csrc`` with nvcc.
1. Kernels at whisper-tiny width (D=384, H=3072, k=32), B=128 and B=4096:
   each kernel against its plain PyTorch version on the same card inputs
   (kernel A sliced and at a row offset, B in bf16 and f32, C), with
   gradients through each autograd.Function against the same Function on
   the CPU (plain forward), and kernel A's loss bit-identical run to run.
   Tolerances: kernel C exact; A and B compute ``pre`` with tensor-core
   sums in another order than the plain f32 product, so >= 99.9% of rows
   must select the same features, A's loss at rtol 1e-4, l0 and the
   active vector equal on those rows, the latent within bf16 rounding
   (atol 1e-2 * max); gradients at rtol 2e-2.  Each row that selects
   differently is printed with the plain pre's gap between its k-th and
   (k+1)-th values and the row's max |pre_card - pre_plain| (kernel A's
   own pre, from its kPre encode); a gap wider than twice that fails.
2. Training through the CLI (``whisper_sae_tpu_torch.train.main``) on a
   synthetic gaussian cache (covariance mostly of rank 64) of 2^18 + 64
   rows x 384 f32 in the JAX
   package's format, with configs/tiny_default.yaml's widths, k, batch 128
   and AMP, 3 epochs (2,048 windowed kernel-A steps and one remainder
   step each) and one dead-feature resample at the third epoch's end.
3. Eval of the trained SAE on held-out rows: bf16 ``topk_sae_apply``
   (kernel B) and the f32 ``TopKSAE`` forward (kernel C).
   Every kernel's launch count is zeroed before phase 2 and must be
   above 0 after phase 3.  Then the trained SAE's forward on the card is
   held against the same SAE on the CPU on 512 rows.
4. Times: a training step's wall time and, under ``torch.profiler``, the
   device's busy time and heaviest operations; then with CUDA events each
   kernel, its plain version and one PyTorch call as a yardstick (the
   bf16 encode product for A and B, ``torch.topk`` for C -- yardsticks,
   not equivalents), beside the least time the card needs for the same
   work.

5. Encoder kernels at whisper-tiny width (D=384, 6 heads, F=1536,
   T=1500, 80 mels), 64 clips: the conv stem, LN+QKV, the attention core
   (also launched as the composed route's flash attention), the
   out-projection, the whole attention block and the MLP block in all
   four output modes, each against its plain version on the same card
   inputs at the one-block bar (max|d| <= 2**-6 max|ref|, mean|d| <=
   2**-9 mean|ref|).  LN+QKV, the out-projection and the MLP block (all
   on the Hopper GEMM of ``ops/csrc/encoder_gemm.cu``) also at every
   width the gate takes (D = 384 .. 1536, heads of 64, F = 4D) on a
   ragged 64*1500 - 37 rows and on 100 rows, the MLP block in all four
   modes (on the ragged rows against its plain version on one row in 16
   of every tile and the whole last tile); they and the attention core
   give the same bits on two launches.
6. Extraction through the CLI (``--extract-only --random-whisper``,
   tiny_default.yaml's widths and layers, the synthetic dataset, 128
   clips, bf16): every encoder kernel's launch count is zeroed before
   and checked after (stem once a batch, the attention launches and the
   MLP block once a layer and batch), the plain versions are called no
   time, and the 8 caches hold 128*1500 (encoder) or 128 (decoder) finite
   rows of 384.  The first 2 clips of each cache are held against the
   same extraction on the CPU (plain versions) at the stack bar (2**-4,
   2**-7 per layer); the f32 mode on the card against the CPU at rtol
   1e-3; one bf16 ``encoder_forward(use_fused=False)`` on 2 clips must
   launch the attention core on the flash route once a layer.  Then the
   CLI trains one epoch from the extracted ``encoder:3`` cache (loss
   finite and falling) and the caches are deleted.
7. Times of the extraction slice: ``extract_activations`` at batch 64
   (bf16, all layers captured, decoder on), the CLI extraction end to
   end, the device's busy share under ``torch.profiler`` and the attention
   and MLP blocks' parts of it, and each
   encoder kernel beside its plain version, its bound and a library
   yardstick (``torch.matmul`` for the projections, the conv1d pair for
   the stem, ``scaled_dot_product_attention`` for the core -- yardsticks,
   not ports).  The kernels run on weights already in their layout (built
   once per parameter tensor); the preparation's one-off time is printed
   on its own line, and the launches of LN+QKV (LN1, the GEMM), the
   out-projection and the MLP block (LN2, fc1, fc2, the final LN), each
   timed alone, on one line a kernel.
8. The coder kernel (``ops/csrc/coder_kernels.cu``; the encodes, the
   ReLU modes' decode and the Skip mode's skip product on
   ``encoder_gemm.cu``) at whisper-tiny width, B=4096, in its five modes
   (Skip and TopK transcoder, ReLU SAE: D=384, H=3072, k=32; TopK and
   ReLU crosscoder: L*D=1536, S=3072), sliced, at a row offset into a
   larger buffer, on a 1,792-row remainder, on ragged 100- and
   1,000-row windows at an offset (whose pad rows, with pre = b_enc
   about half positive, must count nowhere) and at B=32768 (the ReLU
   modes also at phase 9's batch of 128 rows, sliced and at a row
   offset), against its plain version: TopK modes at kernel A's bars
   (with phase 1's print of each row that selects differently, its gap
   held to twice the row's max |pre_card - pre_plain|: the TopK modes
   select on exactly the kPre pre that phase 1's check recomputes);
   ReLU modes with the latent within bf16 rounding (atol 1e-2 *
   max), sum(resid^2), the L1 and the hidden sums at rtol 1e-4, l0 at
   rel 1e-4 and ``active`` equal on >= 99.9% of features.  Gradients
   through each autograd.Function (sliced and windowed, 1024 rows)
   against the same Function on the CPU at rtol 2e-2 (ReLU modes: >=
   99.99% of each gradient's elements, as a pre within rounding of 0
   moves one feature's column); outputs
   bit-identical run to run.
9. The coder slice through its entry points, every coder launch counter
   and the plain-call counters zeroed first: a ReLU SAE through the CLI
   on phase 2's cache (tiny_default.yaml with ``activation: relu``, one
   epoch); ``launch extract --capture-mlp`` of 64 synthetic clips (4
   layer caches and 4 (mlp_in, mlp_out) pairs of 96,000 rows);
   ``launch train-transcoder`` (Skip, then ``--no-skip``) and
   ``launch train-crosscoder`` (TopK, then ``--relu``), 2 epochs at
   batch 4096 and learning rate 1e-2 (the launcher's 1000-step warmup
   would leave 48 steps at a rate too small to see the loss move).
   Windowed launches must equal the windowed steps, sliced launches be
   at least one an epoch (the remainder), the plain versions run no
   time, the losses be finite and fall, the run files exist; each
   trained family's forward on 512 rows on the card is held against the
   same model on the CPU (loss rtol 1e-3, >= 99% of rows selecting the
   same features).  The caches are deleted.
10. Times of the coder slice: each mode at B=128, 4096 and 32768, sliced
    and at a row offset, beside its plain version, its bound and a library
    yardstick (the bf16 encode product, plus the dense decode product in
    ReLU modes), with each launch's device time under ``torch.profiler``
    (ReLU modes: the cast, ``gemm_kernel<4>``, ``gemm_kernel<5>`` and the
    two sums; TopK modes: the cast, the encode ``gemm_kernel<3>``, in Skip
    mode the skip product -- a second ``gemm_kernel<3>``, told apart by
    its place in the call -- ``coder_select_decode_kernel`` and the sum);
    one training step of phase 9's ReLU SAE at batch 128, and of the Skip
    transcoder, the ReLU crosscoder and the TopK crosscoder at batch 4096
    and 32768, wall and device busy time.
11. Whisper-large 32x (D=1280, H=40960, k=32; bench.py:83-112): the
    blocked encode (``ops/csrc/blocked_encode.cu``: per 2048-row chunk
    the centre, the kPre GEMM of ``encoder_gemm.cu`` and the CTA select)
    against its plain version at 8192 rows, 4,200 (two full chunks and a
    ragged one) and a ragged 1,000, for f32 and bf16 rows and both latent
    dtypes, at kernel B's bars (>= 99.9% of rows select the same
    features, values on those rows within 1e-2 * max|ref|), with phase
    1's print of each row that selects differently, its gap held to twice
    the row's max |pre_card - pre_plain| (pre_card: the kPre GEMM on the
    same centred rows, the pre the route selects on); its gradients
    against the CPU on 256 rows (rtol 2e-2, on the rows whose selection
    the two agree on); two launches bit-identical; kernel C's CTA-per-row
    form on [1024, 40960] with tie rows, exact.
12. The whisper-large 32x path through the CLI: a synthetic gaussian
    cache of 6 x 8192 rows x 1280 under ``build/chip_smoke/``, a config
    naming ``openai/whisper-large-v3`` with expansion 32, k 32, batch
    8192, AMP, 2 epochs and ``dead_feature_threshold`` 2, trained by
    ``whisper_sae_tpu_torch.train.main`` with the resample set to fire at
    the last epoch's end (the CLI fixes ``resample_dead_every`` at 5000).
    Every counter is zeroed first; the blocked launches must equal the
    12 steps, kernels A and B and the plain versions run no time, the
    resample runs through kernel C's wide form; the loss falls, decoder
    rows are unit norm, parameters finite; the trained SAE's f32 forward
    on 64 rows on the card agrees with the CPU at phase 11's bars.
13. Times at whisper-large 32x: the blocked encode at 8192 rows beside
    its plain version, its bound and the bf16 ``torch.mm`` of the same
    shape, with each of its three launches' device time under
    ``torch.profiler`` (``split_ms``, a call's four chunks) and the
    product's TFLOP/s; kernel C's wide form on [8192, 40960] beside
    ``torch.topk``; the select's passes a row on that pre (it stops at a
    count of exactly k), which both bounds count; one training step at
    batch 8192 under ``torch.profiler``.

14. Encoder kernels at whisper-large-v3 width (D=1280, 20 heads, F=5120,
    T=1500, 128 mels), 16 clips (the CLI run's batch): the conv stem's
    wide form, the MLP block (all four output modes), LN+QKV, the
    attention core (T unpadded, and with keys from 1437 masked; also as
    the flash route), the out-projection and the whole attention block,
    each against its plain version at the one-block bar; the attention
    core, LN+QKV, the out-projection and the MLP block bit-identical run
    to run, the last three also at every width of the gate on 16*1500 -
    37 and 100 rows, as in phase 5.
15. Whisper-large-v3 extraction through the CLI (``--extract-only
    --random-whisper``, weights made on the card from the config's seed,
    the synthetic dataset, 16 clips, bf16, the full 32+32-layer forward,
    encoder layers 0 and 31 and decoder layer 31 captured): every
    encoder wrapper's count is zeroed before and read after (the wide
    stem once a batch, the attention launches and the MLP block once a
    layer and batch, the narrow stem and the plain versions no time);
    the caches hold 16*1500 (16) finite rows of 1280 and agree
    with ``extract_activations`` on 2 clips at the stack bar.  Then, on
    those 2 clips, every layer of the fused route is held against the
    card's composed route (torch products, the attention core on its
    flash route) from the same input, at the stack bar.
16. Times at whisper-large-v3: one 8-clip batch of ``extract_activations``
    (bf16, every layer captured, decoder on) on the host clock and under
    ``torch.profiler``, beside its operation bound, with the heaviest
    device operations, the attention and MLP blocks' parts of the busy
    time, the device's idle gaps (their count and total, the longest,
    and the host operations that ran in them) and the
    encoder's and the decoder's part on the host clock; each encoder
    kernel beside its plain version, its bound and a library yardstick,
    the weight preparation and the kernels' parts as in phase 7.
17. Out of core through the CLI: a cache of 2 shards (65,536 + 32,768
    rows x 384) trained for one epoch at tiny_default.yaml's widths; the
    CLI streams it batch by batch through the prefetching shard loader,
    as the JAX CLI does: every batch trains (one sliced kernel-A launch
    a step, no windowed launch), the resample set is the bounded
    8 x 8192-row subsample, the loss falls.
18. The launcher's coder jobs past the earlier limits, on synthetic
    caches: ``train-crosscoder --expansion-factor 16`` (L=2, D=384,
    S=6144 > 3072; TopK, then ``--relu``) composes as the JAX package
    does -- no coder-kernel launch, kernel C's wide form for the TopK
    mask; learning rate 1e-2, for ReLU 1e-3 and 4 epochs -- and ``train-transcoder``
    above ``--max-resident-gb`` streams
    chunked epochs through the paired reader (windowed coder launches
    equal to the steps).  Losses finite and falling, run files written.

Before them, one line lists the rows of phases 1, 8 and 11 that select
differently from the plain version, with their gaps.  The last two lines
are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  Scratch files go under ``build/``.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

D, H, K = 384, 3072, 32
BATCHES = (128, 4096)
A_WIDE_BATCH = 32768  # kernel A alone: checked and timed, not trained
# kernel A's four launches, by the profiler's kernel names
A_PARTS = {"centre": "sae_centre_kernel", "encode": "gemm_kernel<3>",
           "select_decode": "sae_select_decode_kernel", "finalize": "sae_loss_finalize_kernel"}
# the coder's ReLU modes' five launches, by the same names
RELU_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<4>", "decode": "gemm_kernel<5>",
              "hsum": "coder_hsum_kernel", "sum": "coder_sum_kernel"}
# the coder's TopK modes' four launches (five in Skip mode: the skip
# product, a second gemm_kernel<3>, follows the encode)
TOPK_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<3>",
              "select_decode": "coder_select_decode_kernel", "sum": "coder_sum_kernel"}
SKIP_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<3>",
              "skip_product": "gemm_kernel<3>", "select_decode": "coder_select_decode_kernel",
              "sum": "coder_sum_kernel"}
N_ROWS = (1 << 18) + 64
EPOCHS = 3
RANK = 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores (also used here for the bisection's int compares), HBM3
PEAK_BF16, PEAK_ALU, PEAK_BYTES = 989e12, 67e12, 3.35e12
SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/sae_kernels.cu"
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")
# extraction slice: whisper-tiny width, 64 clips a batch
ENC_B, ENC_T, ENC_D, ENC_HEADS, ENC_F, N_MELS = 64, 1500, 384, 6, 1536, 80
EXTRACT_CLIPS = 128
ENC_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/encoder_kernels.cu"
# exp per second on the special-function units: 132 SMs x 16 a clock x 1.98 GHz
PEAK_SFU = 132 * 16 * 1.98e9
BLOCK_BAR, STACK_BAR = (2.0**-6, 2.0**-9), (2.0**-4, 2.0**-7)
# coder slice: whisper-tiny width, the launcher's batch and bench.py's
CODER_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/coder_kernels.cu"
CODER_BATCHES = (4096, 32768)
CODER_B = CODER_BATCHES[0]
CODER_TIME_BATCHES = (128, *CODER_BATCHES)  # 128: the CLI's ReLU SAE batch (phase 9)
CODER_MODES = {  # mode: (D, dout, k or None for ReLU, skip, y is x)
    "skip_transcoder": (D, D, K, True, False),
    "topk_transcoder": (D, D, K, False, False),
    "relu_sae": (D, D, None, False, True),
    "topk_crosscoder": (4 * D, 4 * D, K, False, True),
    "relu_crosscoder": (4 * D, 4 * D, None, False, True),
}
LAUNCH_CLIPS = 64
# whisper-large 32x (bench.py:83-112): the blocked encode's geometry
DL, HL, BL = 1280, 40960, 8192
LARGE_STEPS, LARGE_EPOCHS = 6, 2
LARGE_CHECK_ROWS = (BL, 4200, 1000)  # 4200: two full chunks of the blocked encode and a ragged one
BLOCKED_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/blocked_encode.cu"
# the blocked encode's three launches a chunk, by the profiler's kernel names
# (at whisper-large 32x the product walks column tiles first)
BLOCKED_PARTS = {"centre": "sae_centre_kernel", "encode": "gemm_cols_kernel<3>",
                 "select": "blocked_select_kernel"}
ATTN_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/attention_kernel.cu"
GEMM_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/encoder_gemm.cu"
# every width the fused route's gate takes (ops/encoder.py:fused_encoder_supported)
GATE_WIDTHS = (384, 512, 768, 1024, 1280, 1536)
# whisper-large-v3 extraction: bench.py:388-400 times batches of LG_B = 8
# clips; the CLI extracts LG_CLIPS = 16 in one batch (EXTRACT_BATCH is 64),
# and phase 14 holds the kernels against their plain versions at that batch
LV3 = "openai/whisper-large-v3"
LG_B, LG_CLIPS = 8, 16
LG_ENC_LAYERS, LG_DEC_LAYERS = [0, 31], [31]
ENC_REPLACES = {
    "conv_stem": "src/whisper_sae_tpu/ops/pallas_encoder.py:604",
    "ln_qkv": "src/whisper_sae_tpu/ops/pallas_encoder.py:340",
    "self_attention": "src/whisper_sae_tpu/ops/pallas_encoder.py:340",
    "out_proj": "src/whisper_sae_tpu/ops/pallas_encoder.py:340",
    "mlp_block": "src/whisper_sae_tpu/ops/pallas_encoder.py:500",
    "flash_self_attention": "src/whisper_sae_tpu/models/whisper.py:141",
}


class SmokeFailure(RuntimeError):
    pass


# phases 1, 8 and 11: the rows that select differently from the plain version
GAPS: dict[str, list] = {}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, tc_flops: float, alu_ops: float) -> tuple[float, str]:
    """Least time (ms): bytes at the memory rate vs operations at their peak."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16, alu_ops / PEAK_ALU)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def enc_bound(nbytes: float, tc_flops: float, exps: float = 0.0) -> tuple[float, str]:
    """Least time (ms) of an encoder kernel: bytes vs bf16 tensor-core
    operations and, for the attention core, exps on the SFUs."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16, exps / PEAK_SFU)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bar_check(got: torch.Tensor, want: torch.Tensor, bar: tuple[float, float], what: str) -> float:
    """max|d| <= bar[0] * max|ref| and mean|d| <= bar[1] * mean|ref|;
    returns max|d|."""
    g, w = got.float(), want.float().to(got.device)
    check(tuple(g.shape) == tuple(w.shape), f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    d = (g - w).abs()
    mx, mn = float(d.max() / w.abs().max()), float(d.mean() / w.abs().mean())
    check(mx <= bar[0] and mn <= bar[1],
          f"{what}: max rel {mx:.3g}, mean rel {mn:.3g} above the bar {bar}")
    return float(d.max())


def params(seed: int, dev, d: int = D, h: int = H) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    p = {
        "w_enc": torch.randn(d, h, generator=g) * 0.05,
        "b_enc": torch.randn(h, generator=g) * 0.05,
        "b_pre": torch.randn(d, generator=g) * 0.05,
        "w_dec": torch.randn(h, d, generator=g) * 0.05,
        "b_dec": torch.randn(d, generator=g) * 0.05,
    }
    return {k: v.to(dev) for k, v in p.items()}


def agree(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows whose selections match."""
    return ((a > 0) == (b > 0)).all(dim=1)


def selection_gaps(xc, we_t, b_enc, got_hid, want_hid, k: int, what: str) -> list:
    """Each row whose selection differs from the plain version, with the
    plain pre's gap between its k-th and (k+1)-th values, its k-th value
    and the row's max |pre_card - pre_plain| (pre_card: the encode GEMM's
    kPre epilogue on the same bf16 rows, which gives the same bits every
    launch: the pre that kernel A, the coder's TopK modes and the blocked
    encode select on).  Two features can swap across the boundary only if
    the gap is at most the two versions' difference on both, and a
    selected value can change sign only if it is within it of 0, so the
    gap (or the k-th value) is held to twice the row's difference.  Fails
    on any wider gap: the kernel, not the sum order, would be at fault."""
    from whisper_sae_tpu_torch.ops import _build
    from whisper_sae_tpu_torch.utils.device import mm_f32

    bad = (~agree(got_hid, want_hid)).nonzero().flatten()
    if bad.numel() == 0:
        return []
    rows, d = xc.shape
    h = we_t.shape[0]
    pre_card = torch.empty(rows, h, device=xc.device)
    check(_build.load_library().wst_enc_gemm_fwd(
        3, xc.data_ptr(), we_t.data_ptr(), rows, h, d, b_enc.data_ptr(), 1.0, 0,
        pre_card.data_ptr(), None, None, None, torch.cuda.current_stream().cuda_stream) == 0,
        f"{what}: the kPre GEMM did not launch")
    pre_plain = (mm_f32(xc, we_t.t()) + b_enc)[bad]
    top = torch.topk(pre_plain, k + 1, dim=1).values
    gap, kth = top[:, k - 1] - top[:, k], top[:, k - 1]
    diff = (pre_card[bad] - pre_plain).abs().max(dim=1).values
    out = []
    for r, g, v, df in zip(bad.tolist(), gap.tolist(), kth.tolist(), diff.tolist()):
        log(f"    {what}: row {r} selects differently: gap {g:.4g} (k-th value {v:.4g}), "
            f"max|pre_card - pre_plain| {df:.4g}")
        check(g <= 2 * df or abs(v) <= 2 * df,
              f"{what}: row {r}'s gap {g:.4g} is wider than the sum order explains ({2 * df:.4g})")
        out.append({"row": r, "gap": g, "kth": v, "max_pre_diff": df})
    return out


def grads_close(fn, p, cpu_fn, names, what: str) -> None:
    """Gradients of ``fn`` on the card vs the same Function on the CPU
    (plain forward), rtol 2e-2 (bf16 products, other sum order)."""
    out = {}
    for key, f, src in (("card", fn, p), ("cpu", cpu_fn, {k: v.cpu() for k, v in p.items()})):
        q = {k: v.clone().requires_grad_(True) for k, v in src.items()}
        f(q).backward()
        out[key] = {n: q[n].grad for n in names}
    for n in names:
        want = out["cpu"][n]
        err = float((out["card"][n].cpu() - want).abs().max())
        tol = 2e-2 * float(want.abs().max())
        check(torch.allclose(out["card"][n].cpu(), want, rtol=2e-2, atol=tol),
              f"{what}: d{n} differs from the plain version (max abs {err:.3g} > {tol:.3g})")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernel_a(cuda_sae, b: int, p: dict, x, buf, errs: dict) -> None:
    """Kernel A against its plain version at ``b`` rows, sliced and at a
    row offset into an epoch buffer; two launches give the same bits."""
    we_t = cuda_sae._bf16_t(p["w_enc"])
    wd = p["w_dec"].bfloat16()
    b_out = p["b_dec"] + p["b_pre"]
    for what, data, off in (("fused_sae_loss", x, 0), ("fused_sae_loss_indexed", buf, b)):
        got = cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"], p["b_pre"], wd, b_out, K)
        want = cuda_sae.fused_sae_loss_plain(data[off:off + b], we_t, p["b_enc"], p["b_pre"],
                                             wd, b_out, K)
        torch.cuda.synchronize()
        ok = agree(got[3], want[3])
        share = float(ok.float().mean())
        check(share >= 0.999, f"{what} B={b}: selection agrees on {share:.4%} of rows")
        GAPS[f"{what} B={b}"] = selection_gaps(got[5], we_t, p["b_enc"], got[3], want[3], K,
                                               f"{what} B={b}")
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        check(rel <= 1e-4, f"{what} B={b}: loss rel err {rel:.3g} > 1e-4")
        hk, hp = got[3][ok] > 0, want[3][ok] > 0
        check(int(hk.sum()) == int(hp.sum()), f"{what} B={b}: l0 differs on agreeing rows")
        check(torch.equal(hk.any(0), hp.any(0)), f"{what} B={b}: active differs on agreeing rows")
        if bool(ok.all()):
            check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
                  f"{what} B={b}: l0/active outputs differ")
        check(torch.equal(got[5], want[5]), f"{what} B={b}: centred rows differ")
        errs[what] = max(errs.get(what, 0.0), float((got[4][ok] - want[4][ok]).abs().max()))
        log(f"  {what:24s} B={b:5d}: rows agreeing {share:.4%}, loss {float(got[0]):.7g} "
            f"vs plain {float(want[0]):.7g}, l0 {float(got[1]):.3f}")
    a = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    a2 = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    check(all(torch.equal(u, v) for u, v in zip(a, a2)), f"kernel A B={b}: loss not bit-identical")


def kernel_phase(dev, cuda_sae, cuda_topk, topk) -> dict:
    errs: dict[str, float] = {}
    for b in BATCHES:
        p = params(b, dev)
        gen = torch.Generator().manual_seed(b + 1)
        x = torch.randn(b, D, generator=gen).to(dev)
        buf = torch.randn(3 * b, D, generator=gen).to(dev)
        we_t = cuda_sae._bf16_t(p["w_enc"])
        check_kernel_a(cuda_sae, b, p, x, buf, errs)

        # kernel B, bf16 and f32 latent
        for out_dtype in (torch.bfloat16, torch.float32):
            got = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
            want = cuda_sae.topk_encode_plain(x, we_t, p["b_enc"], p["b_pre"], K, out_dtype)
            torch.cuda.synchronize()
            ok = agree(got, want)
            check(float(ok.float().mean()) >= 0.999, f"fused_topk_encode B={b}: selection")
            err = float((got[ok].float() - want[ok].float()).abs().max())
            check(err <= 1e-2 * float(want.float().abs().max()), f"fused_topk_encode B={b}: values")
            errs["fused_topk_encode"] = max(errs.get("fused_topk_encode", 0.0), err)

        # kernel C, exact
        pre = torch.randn(b, H, generator=gen).to(dev)
        pre[:4] = torch.round(pre[:4] * 2) / 2
        got, want = cuda_topk.topk_mask_fwd(pre, K), topk.topk_mask_plain(pre, K)
        check(torch.equal(got, want), f"topk_mask B={b}: differs from the plain version")
        errs["topk_mask"] = 0.0
        log(f"  fused_topk_encode, topk_mask B={b:5d}: agree")

        # gradients through each autograd.Function
        if b == BATCHES[-1]:
            grads_close(lambda q: cuda_sae.fused_sae_loss(x, *(q[n] for n in NAMES), K)[0], p,
                        lambda q: cuda_sae.fused_sae_loss(x.cpu(), *(q[n] for n in NAMES), K)[0],
                        NAMES, "fused_sae_loss")
            grads_close(lambda q: cuda_sae.fused_sae_loss_indexed(buf, 1, *(q[n] for n in NAMES), K, b)[0],
                        p, lambda q: cuda_sae.fused_sae_loss_indexed(
                            buf.cpu(), 1, *(q[n] for n in NAMES), K, b)[0],
                        NAMES, "fused_sae_loss_indexed")
            g = torch.randn(b, H, generator=gen)
            grads_close(lambda q: (cuda_sae.fused_topk_encode(x, q["w_enc"], q["b_enc"], q["b_pre"], K,
                                                              torch.float32) * g.to(dev)).sum(), p,
                        lambda q: (cuda_sae.fused_topk_encode(x.cpu(), q["w_enc"], q["b_enc"],
                                                              q["b_pre"], K, torch.float32) * g).sum(),
                        ("w_enc", "b_enc", "b_pre"), "fused_topk_encode")
            pc = pre.clone().requires_grad_(True)
            cuda_topk.topk_mask(pc, K).backward(g.to(dev))
            check(torch.equal(pc.grad, torch.where(want > 0, g.to(dev), 0.0)), "topk_mask: gradient")
            log(f"  gradients B={b}: agree (rtol 2e-2)")
    b = A_WIDE_BATCH
    gen = torch.Generator().manual_seed(b + 1)
    check_kernel_a(cuda_sae, b, params(b, dev), torch.randn(b, D, generator=gen).to(dev),
                   torch.randn(3 * b, D, generator=gen).to(dev), errs)
    return errs


# ---------------------------------------------------------------------------
# phases 2-3: the main path through the CLI, then eval
# ---------------------------------------------------------------------------


def gaussian_rows(n: int, gen: torch.Generator, mix: torch.Tensor) -> torch.Tensor:
    """Gaussian rows whose covariance is mostly of rank ``RANK`` (plus
    isotropic noise), so a k=32 SAE has structure to find."""
    z = torch.randn(n, RANK, generator=gen, device=mix.device)
    return z @ mix + 0.1 * torch.randn(n, mix.shape[1], generator=gen, device=mix.device)


def write_cache(work: Path, dev, cfg_mod, cache_mod) -> torch.Tensor:
    """Write the training cache; returns the mixing matrix for held-out rows."""
    cfg = cfg_mod.ExperimentConfig.from_yaml(ROOT / "configs" / "tiny_default.yaml")
    cache = cache_mod.FeatureCache(work / "cache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    for start in range(0, N_ROWS, 1 << 16):
        writer.append(gaussian_rows(min(1 << 16, N_ROWS - start), gen, mix).cpu().numpy())
    meta = writer.finalize(num_samples=N_ROWS // 1500)
    check(meta.num_tokens == N_ROWS and meta.hidden_dim == D, "cache metadata")
    return mix


def write_config(work: Path) -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    check((cfg["sae"]["k"], cfg["sae"]["expansion_factor"], cfg["training"]["batch_size"],
           cfg["training"]["use_amp"]) == (K, H // D, 128, True), "tiny_default.yaml widths changed")
    cfg["training"].update(epochs=EPOCHS, warmup_steps=200)
    cfg["sae"]["dead_feature_threshold"] = 2
    cfg["data"]["cache_dir"] = str(work / "cache")
    cfg["output_dir"] = str(work / "out")
    path = work / "tiny_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def main_path(work: Path, dev, mix: torch.Tensor, train_mod, sae_mod):
    """Train through the CLI's ``main``, check what it wrote, then eval the
    trained SAE on held-out rows; returns (trainer, sae, held-out rows)."""
    t0 = time.perf_counter()
    (trainer,) = train_mod.main(["--config", str(write_config(work)), "--layer", "encoder:0",
                                 "--no-wandb"]).values()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    run_dir = trainer.run_dir
    steps_per_epoch = N_ROWS // 128 + 1
    rows = json.loads((run_dir / "metrics.json").read_text())
    check(len(rows) == EPOCHS * steps_per_epoch, f"metrics.json has {len(rows)} rows")
    check(all(set(r) == {"step", "loss", "reconstruction_loss", "sparsity_loss", "l0",
                         "dead_feature_ratio", "learning_rate"} for r in rows), "metrics.json keys")
    losses = np.array([r["loss"] for r in rows])
    check(bool(np.isfinite(losses).all()), "non-finite loss")
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    check(last < 0.8 * first, f"loss did not fall ({first:.5f} -> {last:.5f})")
    check(trainer.num_resampled_total > 0, "no dead-feature resample fired")
    with np.load(run_dir / "sae_final.npz") as z:
        norms = np.linalg.norm(z["w_dec"], axis=1)
        check(z["w_enc"].shape == (D, H), "sae_final.npz shapes")
    check(bool(np.allclose(norms, 1.0, rtol=1e-5)), "decoder rows are not unit norm")
    check((run_dir / "sae_final.pt").exists(), "sae_final.pt missing")
    log(f"  trained {len(rows)} steps in {train_s:.1f} s: loss {first:.5f} -> {last:.5f}, "
        f"resampled {trainer.num_resampled_total} features, "
        f"{EPOCHS * N_ROWS / train_s:,.0f} act/s end to end (cache load and setup included)")

    # eval on held-out rows through the trained SAE
    sae = sae_mod.load_trained_sae(run_dir).eval()
    x = gaussian_rows(8192, torch.Generator(device=dev).manual_seed(99), mix)
    with torch.no_grad():
        out_bf16, active = sae_mod.topk_sae_apply(sae.params, x, K, torch.bfloat16)
        out_f32 = sae(x)
    for name, out in (("bf16", out_bf16), ("f32", out_f32)):
        check(out.hidden.shape == (8192, H) and out.reconstructed.shape == (8192, D),
              f"eval {name}: shapes")
        check(bool(torch.isfinite(out.reconstructed).all()), f"eval {name}: non-finite")
        check(0 < float(out.l0) <= K + 1e-3, f"eval {name}: l0 {float(out.l0)}")
    rel = abs(float(out_bf16.loss) - float(out_f32.loss)) / float(out_f32.loss)
    check(rel < 2e-2, f"eval: bf16 and f32 losses differ by {rel:.3g}")
    log(f"  eval on 8192 held-out rows (right after the resample): loss bf16 "
        f"{float(out_bf16.loss):.5f} / f32 {float(out_f32.loss):.5f}, l0 {float(out_f32.l0):.2f}, "
        f"{int(active.sum())} features active")
    return trainer, sae, x


def eval_against_cpu(sae, x: torch.Tensor, sae_mod) -> None:
    """The trained SAE's f32 forward on the card against the same SAE on
    the CPU (plain versions) on 512 held-out rows: >= 99% of rows select
    the same features, loss at rtol 1e-3."""
    cpu_params = {k: v.detach().cpu() for k, v in sae.params.items()}
    ref, _ = sae_mod.topk_sae_apply(cpu_params, x[:512].cpu(), K, torch.float32)
    with torch.no_grad():
        card, _ = sae_mod.topk_sae_apply(sae.params, x[:512], K, torch.float32)
    share = float(agree(card.hidden.cpu(), ref.hidden).float().mean())
    rel = abs(float(card.loss) - float(ref.loss)) / float(ref.loss)
    check(share >= 0.99 and rel < 1e-3,
          f"eval: card vs CPU on 512 rows: {share:.2%} rows agree, loss rel err {rel:.3g}")
    log(f"  trained SAE on 512 rows, card vs CPU: {share:.2%} rows agree, loss rel err {rel:.2g}")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def step_profile(trainer, rows, steps: int) -> dict:
    """Where a training step's time goes: ``steps`` fused-epoch steps of
    ``trainer`` over ``rows`` (a tensor or an (x, y) pair on the card),
    timed on the host clock without the profiler, then once under
    ``torch.profiler`` for the device's busy time per step and its
    heaviest operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = trainer.config.batch_size
    trainer.train_epoch_fused(rows, shuffle=False)  # warm
    t0 = time.perf_counter()
    trainer.train_epoch_fused(rows, shuffle=False)  # ends with its one metrics fetch
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch_fused(rows, shuffle=False)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"  step at batch {b}: {wall_ms:.3f} ms wall ({b / wall_ms * 1e3:,.0f} act/s)")
    res = {"batch": b, "wall_ms": wall_ms, "busy_ms": busy_ms if busy_ms > 0 else None}
    if busy_ms <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return res
    res["idle_share"] = max(0.0, 1 - busy_ms / wall_ms)
    log(f"  device busy {busy_ms:.3f} ms per step (profiled run), idle share "
        f"{res['idle_share']:.1%} of the unprofiled step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.4f} ms/step  {e.count // steps:3d}x  "
            f"{e.key[:90]}")
    return res


def launch_split(fn, parts: dict, calls: int = 10) -> dict:
    """Device ms per launch of each kernel of ``parts`` (part: profiler
    name, in the order a call of ``fn`` launches them: kernel A's four,
    the coder's five or four), from ``torch.profiler`` over ``calls``
    calls (None where the profiler saw no device time).  Where parts share
    a name (the Skip mode's encode and skip product, both gemm_kernel<3>),
    the n-th launch of a run of that name, in time order, is the n-th of
    those parts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    us, n = dict.fromkeys(parts, 0.0), dict.fromkeys(parts, 0)
    prev, run = None, 0
    for e in kernels:
        hits = [part for part, kname in parts.items() if kname in e.name]
        kname = parts[hits[0]] if hits else None
        run = run + 1 if kname is not None and kname == prev else 0
        prev = kname
        if hits:
            part = hits[min(run, len(hits) - 1)]
            us[part] += e.time_range.elapsed_us()
            n[part] += 1
    return {part: us[part] / 1e3 / n[part] if us[part] > 0 else None for part in parts}


def times(dev, cuda_sae, cuda_topk, topk) -> dict:
    res: dict = {}
    for b in (*BATCHES, A_WIDE_BATCH):
        p = params(7, dev)
        x = torch.randn(b, D, generator=torch.Generator().manual_seed(8)).to(dev)
        buf = torch.cat([torch.randn_like(x), x, torch.randn_like(x)])
        we_t = cuda_sae._bf16_t(p["w_enc"])
        wd, b_out = p["w_dec"].bfloat16(), p["b_dec"] + p["b_pre"]
        xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
        _, _, active, hid, _, _ = cuda_sae._fused_loss_launch(x, 0, b, we_t, p["b_enc"], p["b_pre"],
                                                              wd, b_out, K)
        nnz, n_active = int((hid > 0).sum()), int(active.sum())
        lib_gemm = time_ms(lambda: torch.matmul(xc, w_bf))

        # A: x, W_enc^T, W_dec rows this batch selects, biases in; latent,
        # residual, centred rows, counts out
        a_bytes = (b * D * 4 + D * H * 2 + n_active * D * 2 + (H + 2 * D) * 4
                   + b * H * 2 + b * D * 4 + b * D * 2 + (H + 1) * 4)
        a_bound = bound(a_bytes, 2 * b * D * H + 2 * nnz * D, 32 * b * H)
        a_plain = time_ms(lambda: cuda_sae.fused_sae_loss_plain(x, we_t, p["b_enc"], p["b_pre"], wd,
                                                                b_out, K), iters=5, warmup=1)
        # sliced, and at a row offset into a 3-batch epoch buffer
        for name, data, off in (("fused_sae_loss", x, 0), ("fused_sae_loss_indexed", buf, b)):
            launch = lambda: cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"],  # noqa: E731
                                                         p["b_pre"], wd, b_out, K)
            a_ms = time_ms(launch)
            res[(name, b)] = (a_ms, a_plain, *a_bound, lib_gemm)
            res[("split", name, b)] = split = launch_split(launch, A_PARTS)
            log(f"  {name:24s} B={b:5d}: launches in ms: "
                + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                            for k_, v in split.items()))
        if b not in BATCHES:
            continue

        b_bytes = b * D * 4 + D * H * 2 + (H + D) * 4 + b * H * 2
        b_bound = bound(b_bytes, 2 * b * D * H, 32 * b * H)
        b_ms = time_ms(lambda: cuda_sae._topk_encode_launch(x, we_t, p["b_enc"], p["b_pre"], K,
                                                            torch.bfloat16))
        b_plain = time_ms(lambda: cuda_sae.topk_encode_plain(x, we_t, p["b_enc"], p["b_pre"], K,
                                                             torch.bfloat16), iters=5, warmup=1)
        res[("fused_topk_encode", b)] = (b_ms, b_plain, *b_bound, lib_gemm)

        pre = (torch.matmul(xc.float(), w_bf.float()) + p["b_enc"]).contiguous()
        c_bound = bound(2 * b * H * 4, 0, 32 * b * H)
        c_ms = time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K))
        c_plain = time_ms(lambda: topk.topk_mask_plain(pre, K), iters=5, warmup=1)
        c_lib = time_ms(lambda: torch.topk(pre, K))
        res[("topk_mask", b)] = (c_ms, c_plain, *c_bound, c_lib)
    return res


# ---------------------------------------------------------------------------
# phases 5-7: the extraction slice
# ---------------------------------------------------------------------------


def encoder_inputs(dev, W, CE, arch=None, b: int = ENC_B) -> dict:
    """A bf16 encoder (weights, biases and LN parameters all randomised;
    whisper-tiny unless ``arch`` is given) and a batch of ``b`` random mels
    on the card, with the inputs of every encoder kernel."""
    arch = arch or W.arch_for("openai/whisper-tiny")
    g = torch.Generator().manual_seed(11)
    p = W.init_whisper(g, arch)["encoder"]
    p = W._tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=g), p)
    enc = W.params_to(W.cast_params(p, torch.bfloat16), dev)
    lp = W._layer(enc["layers"], 0)
    mel = (torch.randn(b, arch.n_mels, 2 * ENC_T, generator=g) * 0.5).to(dev).bfloat16()
    return {"enc": enc, "lp": lp, "mel": mel, "b": b, "d": arch.d_model, "f": arch.ffn_dim,
            "heads": arch.num_heads, "n_mels": arch.n_mels,
            "stem": (mel, enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"],
                     enc["pos"]),
            "final_ln": (enc["ln_f_g"].float(), enc["ln_f_b"].float())}


# the MLP block's output modes: (capture, final-LN capture, its dtype)
MLP_MODES = ((False, False, torch.bfloat16), (True, False, torch.bfloat16),
             (False, True, torch.bfloat16), (True, True, torch.float32))


def encoder_kernel_phase(dev, W, E, CE, arch=None, b: int = ENC_B) -> tuple[dict, dict]:
    """Phases 5 and 14; returns (max abs errors by kernel, the inputs for
    the times)."""
    inp = encoder_inputs(dev, W, CE, arch, b)
    lp, errs, d, heads = inp["lp"], {}, inp["d"], inp["heads"]
    before = enc_launches(CE)
    x = E.conv_stem_plain(*inp["stem"])
    errs["conv_stem"] = bar_check(CE.conv_stem_fwd(*inp["stem"]), x, BLOCK_BAR, "conv_stem")
    rows = x.view(-1, d)
    qkv = E.ln_qkv_plain(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    got = CE.ln_qkv_fwd(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    errs["ln_qkv"] = max(bar_check(a, w, BLOCK_BAR, f"ln_qkv {n}")
                         for n, a, w in zip("qkv", got, qkv))
    q, k, v = (a.view(b, ENC_T, d) for a in qkv)
    attn = E.self_attention_plain(q, k, v, heads)
    core = CE.self_attention_fwd(q, k, v, heads)
    errs["self_attention"] = bar_check(core, attn, BLOCK_BAR, "self_attention")
    check(torch.equal(core, CE.self_attention_fwd(q, k, v, heads)),
          "self_attention: two launches differ")
    errs["self_attention"] = max(errs["self_attention"], bar_check(
        CE.self_attention_fwd(q, k, v, heads, 1437), E.self_attention_plain(q, k, v, heads, 1437),
        BLOCK_BAR, "self_attention, keys from 1437 masked"))
    errs["flash_self_attention"] = bar_check(CE.flash_self_attention_fwd(q, k, v, heads),
                                             attn, BLOCK_BAR, "flash_self_attention")
    arows = attn.view(-1, d)
    errs["out_proj"] = bar_check(CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                                 E.out_proj_plain(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                                 BLOCK_BAR, "out_proj")
    check(all(torch.equal(a, w) for a, w in zip(got, CE.ln_qkv_fwd(
        rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads))), "ln_qkv: two launches differ")
    check(torch.equal(CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                      CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"])),
          "out_proj: two launches differ")
    sweep = gemm_width_sweep(dev, E, CE, b)
    block = E.attention_block_plain(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    block_err = bar_check(CE.attention_block_fwd(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads),
                          block, BLOCK_BAR, "attention block")
    brows = block.view(-1, d)
    errs["mlp_block"] = 0.0
    for capture, final_ln, cap_dt in MLP_MODES:
        fl = inp["final_ln"] if final_ln else None
        got = CE.mlp_block_fwd(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
        want = E.mlp_block_plain(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
        got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
        check(len(got) == len(want) and all(a.dtype == w.dtype for a, w in zip(got, want)),
              f"mlp_block capture={capture} final_ln={final_ln}: outputs differ in kind")
        for a, w in zip(got, want):
            errs["mlp_block"] = max(errs["mlp_block"], bar_check(
                a, w, BLOCK_BAR, f"mlp_block capture={capture} final_ln={final_ln}"))
    for name in sweep:
        errs[name] = max(errs[name], sweep[name])
    torch.cuda.synchronize()
    forms = {k: n - before[k] for k, n in enc_launches(CE).items()
             if k.startswith(("conv_stem", "mlp_block")) and n > before[k]}
    log("  " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f", attention block {block_err:.3g} (max abs err, each within the one-block bar; "
        f"B={b}; stem and MLP forms launched {forms}; the attention core, LN+QKV, the "
        "out-projection and the MLP block bit-identical run to run)")
    inp.update(x=x, rows=rows, q=q, k=k, v=v, arows=arows, brows=brows)
    return errs, inp


def mlp_sample(n: int) -> torch.Tensor:
    """Rows the width sweep holds against the MLP block's plain version:
    one in 16 of every 128-row tile, at a position that moves from tile
    to tile (all 16 residues over 16 tiles), and the whole last tile."""
    r = torch.arange(n)
    return r[((r + r // 128) % 16 == 0) | (r >= (n - 1) // 128 * 128)]


def gemm_width_sweep(dev, E, CE, b: int) -> dict:
    """LN+QKV, the out-projection and the MLP block (the Hopper GEMM of
    ``ops/csrc/encoder_gemm.cu``) against their plain versions at every
    width of the gate, heads of 64, F = 4D, on a ragged ``b*T - 37`` rows
    and on 100 rows, at the one-block bar, the MLP block in all four
    output modes; two launches equal.  On the ragged rows the MLP block's
    plain version runs on the rows of ``mlp_sample`` (the block is row by
    row; its f32 products on every row of every width would take minutes).
    Returns the max abs errors."""
    errs = {"ln_qkv": 0.0, "out_proj": 0.0, "mlp_block": 0.0}
    for d in GATE_WIDTHS:
        g = torch.Generator().manual_seed(d)

        def r(*shape, scale=0.05):
            return (torch.randn(*shape, generator=g) * scale).to(dev).bfloat16()

        p = {"wq": r(d, d), "wk": r(d, d), "wv": r(d, d), "wo": r(d, d), "bq": r(d),
             "bv": r(d), "bo": r(d)}
        ln_g, ln_b, heads = 1 + r(d), r(d), d // 64
        mlp = {"w1": r(d, 4 * d, scale=d ** -0.5), "b1": r(4 * d),
               "w2": r(4 * d, d, scale=(4 * d) ** -0.5), "b2": r(d)}
        fl = ((1 + r(d)).float(), r(d).float())
        for n in (b * ENC_T - 37, 100):
            x = r(n, d, scale=1.0)
            got = CE.ln_qkv_fwd(x, ln_g, ln_b, p, heads)
            want = E.ln_qkv_plain(x, ln_g, ln_b, p, heads)
            errs["ln_qkv"] = max([errs["ln_qkv"]] + [bar_check(a, w, BLOCK_BAR, f"ln_qkv {c} D={d} "
                                                               f"rows={n}")
                                                     for c, a, w in zip("qkv", got, want)])
            check(all(torch.equal(a, w) for a, w in zip(got, CE.ln_qkv_fwd(x, ln_g, ln_b, p, heads))),
                  f"ln_qkv D={d} rows={n}: two launches differ")
            out = CE.out_proj_fwd(got[2], x, p["wo"], p["bo"])
            errs["out_proj"] = max(errs["out_proj"], bar_check(
                out, E.out_proj_plain(got[2], x, p["wo"], p["bo"]), BLOCK_BAR,
                f"out_proj D={d} rows={n}"))
            check(torch.equal(out, CE.out_proj_fwd(got[2], x, p["wo"], p["bo"])),
                  f"out_proj D={d} rows={n}: two launches differ")
            del got, want, out
            rows = mlp_sample(n).to(dev)
            # out, ln_f(out) in f32, mlp_in, mlp_out: every mode's outputs
            ref = E.mlp_block_plain(x[rows], ln_g, ln_b, mlp, True, fl, torch.float32)
            for capture, final_ln, cap_dt in MLP_MODES:
                what = f"mlp_block D={d} rows={n} capture={capture} final_ln={final_ln}"
                f_ln = fl if final_ln else None
                got = CE.mlp_block_fwd(x, ln_g, ln_b, mlp, capture, f_ln, cap_dt)
                again = CE.mlp_block_fwd(x, ln_g, ln_b, mlp, capture, f_ln, cap_dt)
                got, again = (o if isinstance(o, tuple) else (o,) for o in (got, again))
                want = ([ref[0]] + ([ref[1].to(cap_dt)] if final_ln else [])
                        + (list(ref[2:]) if capture else []))
                check(len(got) == len(want) and all(a.dtype == w.dtype for a, w in zip(got, want)),
                      f"{what}: outputs differ in kind")
                for a, w, a2 in zip(got, want, again):
                    errs["mlp_block"] = max(errs["mlp_block"], bar_check(a[rows], w, BLOCK_BAR, what))
                    check(torch.equal(a, a2), f"{what}: two launches differ")
                del got, again
            del x, ref
    log(f"  LN+QKV, out-projection and MLP block (4 modes) at D={list(GATE_WIDTHS)}, rows "
        f"{b * ENC_T - 37} and 100: max abs err {errs['ln_qkv']:.3g} / {errs['out_proj']:.3g} / "
        f"{errs['mlp_block']:.3g}, each within the one-block bar, two launches equal")
    return errs


def extraction_config(work: Path) -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    check(cfg["whisper"]["model_name"] == "openai/whisper-tiny" and cfg["training"]["use_amp"]
          and cfg["encoder_layers"] == [0, 1, 2, 3] and cfg["decoder_layers"] == [0, 1, 2, 3],
          "tiny_default.yaml's model, layers or AMP changed")
    cfg["data"].update(dataset_name="synthetic", max_samples=EXTRACT_CLIPS,
                       cache_dir=str(work / "xcache"))
    cfg["training"].update(epochs=1, warmup_steps=100)
    cfg["output_dir"] = str(work / "xout")
    cfg["experiment_name"] = "extract_smoke"
    path = work / "extract_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


ENC_WRAPPERS = ("conv_stem", "ln_qkv", "self_attention", "out_proj", "mlp_block",
                "flash_self_attention")
WIDE_FORMS = {"conv_stem_wide": "conv_stem"}  # D > 512


def enc_source(name: str) -> str:
    if "attention" in name:
        return ATTN_SOURCE
    return ENC_SOURCE if name == "conv_stem" else GEMM_SOURCE


def prep_entry(name: str, parts: dict) -> dict:
    """The ``kernels`` line's extra keys of an encoder kernel: the one-off
    weight preparation and, for LN+QKV, the out-projection and the MLP
    block, the parts timed alone (the LN launches, the GEMMs)."""
    key = {"ln_qkv": "qkv", "out_proj": "out_proj", "mlp_block": "mlp", "conv_stem": "stem"}
    out = {}
    if name in key:
        out["weight_prep_ms"] = parts["prep_ms"][key[name]]
    if name in parts["parts_ms"]:
        out["parts_ms"] = parts["parts_ms"][name]
    return out


def enc_launches(CE) -> dict:
    """Launches by kernel, the stem's wide form apart."""
    counts = {name: getattr(CE, f"{name}_fwd").launches for name in ENC_WRAPPERS}
    counts.update({wide: getattr(CE, f"{name}_fwd").wide_launches
                   for wide, name in WIDE_FORMS.items()})
    return counts


def reset_enc_launches(CE) -> None:
    for name in ENC_WRAPPERS:
        getattr(CE, f"{name}_fwd").launches = 0
    for name in WIDE_FORMS.values():
        getattr(CE, f"{name}_fwd").wide_launches = 0


def extraction_path(work: Path, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E, CE) -> dict:
    """Phase 6; returns launches by kernel and the CLI's end-to-end clips/s."""
    path = extraction_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    reset_enc_launches(CE)
    E.plain_calls.clear()
    t0 = time.perf_counter()
    out = train_mod.main(["--config", str(path), "--extract-only", "--random-whisper",
                          "--no-wandb"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    log(f"  CLI extracted {EXTRACT_CLIPS} clips in {extract_s:.2f} s "
        f"({EXTRACT_CLIPS / extract_s:,.1f} clips/s end to end: mel, forward, transfer, disk); "
        f"launches {launches}, plain-version calls {dict(E.plain_calls)}")
    check(out == {}, "--extract-only trained something")
    batches = -(-EXTRACT_CLIPS // 64)
    layers = len(cfg.encoder_layers)
    want = {"conv_stem": batches, "ln_qkv": layers * batches, "self_attention": layers * batches,
            "out_proj": layers * batches, "mlp_block": layers * batches,
            "flash_self_attention": 0, "conv_stem_wide": 0}
    check(launches == want, f"extraction launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"plain versions ran on the card: {E.plain_calls}")

    # the 8 caches, then the first 2 clips against the CPU
    cache = cache_mod.FeatureCache(work / "xcache" / "features", cfg.whisper, cfg.data)
    arch = W.arch_for(cfg.whisper.model_name)
    # the CLI makes the weights on the card from the config's seed
    params = W.params_to(W.init_whisper(torch.Generator(device=dev).manual_seed(cfg.training.seed),
                                        arch), "cpu")
    ds = ds_mod.SyntheticSpeechDataset(EXTRACT_CLIPS, seed=cfg.training.seed, n_mels=arch.n_mels)
    mel2 = torch.from_numpy(np.stack([ds[i]["input_features"] for i in range(2)]))
    ref = W.extract_activations(params, mel2, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16)
    worst = {}
    for comp, n_layers, tokens in (("encoder", arch.encoder_layers, ENC_T),
                                   ("decoder", arch.decoder_layers, 1)):
        for layer in range(n_layers):
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim, meta.num_samples, meta.dtype)
                  == (EXTRACT_CLIPS * tokens, ENC_D, EXTRACT_CLIPS, "float32"),
                  f"{comp}:{layer} metadata {meta}")
            rows, _ = cache.load(comp, layer)
            check(bool(torch.isfinite(rows).all()), f"{comp}:{layer}: non-finite rows")
            bar_check(rows[:2 * tokens], ref[comp][layer].reshape(-1, ENC_D), STACK_BAR,
                      f"{comp}:{layer} first 2 clips, card vs CPU")
            d = (rows[:2 * tokens] - ref[comp][layer].reshape(-1, ENC_D).float()).abs()
            worst[f"{comp}:{layer}"] = float(d.mean() / ref[comp][layer].float().abs().mean())
            del rows
    log(f"  8 caches of 128 clips; first 2 clips vs the CPU, mean rel err by layer: "
        + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + " (stack bar 2**-7)")

    # the f32 mode on the card against the CPU
    p_dev = W.params_to(params, dev)
    f32_card = W.extract_activations(p_dev, mel2.to(dev), arch)
    f32_cpu = W.extract_activations(params, mel2, arch)
    for key, want_t in f32_cpu.items():
        try:
            torch.testing.assert_close(f32_card[key].cpu(), want_t, rtol=1e-3, atol=1e-4)
        except AssertionError as e:
            raise SmokeFailure(f"f32 extraction {key}: card vs CPU: {e}") from None
    log("  f32 extraction on 2 clips: card equals the CPU at rtol 1e-3")

    # the composed route sends its attention core to the kernel (row 11)
    CE.flash_self_attention_fwd.launches = 0
    with torch.no_grad():
        last, outs = W.encoder_forward(W.cast_params(p_dev, torch.bfloat16),
                                       mel2.to(dev).bfloat16(), arch, use_fused=False)
    torch.cuda.synchronize()
    launches["flash_self_attention"] = CE.flash_self_attention_fwd.launches
    check(launches["flash_self_attention"] == arch.encoder_layers,
          f"flash route: {launches['flash_self_attention']} launches")
    check(bool(torch.isfinite(outs.float()).all()), "flash route: non-finite")
    fused = W.extract_activations(p_dev, mel2.to(dev), arch, compute_dtype=torch.bfloat16,
                                  apply_layer_norm=False, with_decoder=False)
    for layer in range(arch.encoder_layers):
        bar_check(outs[layer], fused["encoder"][layer], STACK_BAR,
                  f"composed bf16 route layer {layer} vs fused")
    log(f"  composed bf16 route on 2 clips: {launches['flash_self_attention']} flash-route "
        "launches, layers within the stack bar of the fused route")

    # the two slices meet: train one epoch from the extracted encoder:3 cache
    t0 = time.perf_counter()
    (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:3",
                                 "--no-wandb"]).values()
    train_s = time.perf_counter() - t0
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    losses = np.array([r["loss"] for r in rows])
    check(len(rows) == -(-EXTRACT_CLIPS * ENC_T // 128), f"metrics.json has {len(rows)} rows")
    check(bool(np.isfinite(losses).all()), "training on the extracted cache: non-finite loss")
    tenth = max(1, len(losses) // 10)
    first, last_l = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    check(last_l < first, f"training on the extracted cache: loss did not fall "
                          f"({first:.5f} -> {last_l:.5f})")
    log(f"  trained encoder:3 from the extracted cache, {len(rows)} steps in {train_s:.1f} s: "
        f"loss {first:.5f} -> {last_l:.5f}")
    shutil.rmtree(work / "xcache", ignore_errors=True)
    return {"launches": launches, "cli_clips_per_s": EXTRACT_CLIPS / extract_s}


ENC_BLOCKS = ("attention_block", "mlp_block")


@contextlib.contextmanager
def annotated_blocks(W):
    """Each call of the encoder's attention and MLP blocks inside a
    ``torch.profiler.record_function`` range ``enc.<block>``, for a
    profiled run only: the trace then gives each block's device time (the
    kernels launched inside the range)."""
    from torch.profiler import record_function

    ops = W.encoder_ops
    saved = {name: getattr(ops, name) for name in ENC_BLOCKS}

    def wrap(name, fn):
        def annotated(*args, **kwargs):
            with record_function(f"enc.{name}"):
                return fn(*args, **kwargs)
        return annotated

    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def device_ops(events) -> list:
    """The device's own activities (kernels, copies, memsets) among a
    trace's events: the ``enc.<block>`` ranges' device-side spans are left
    out, so nothing is counted twice."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA and not e.key.startswith("enc.")]


def block_shares(prof, batches: int, busy: float) -> dict:
    """ms a batch of each ``enc.<block>`` range on the device (from its
    first kernel's start to its last kernel's end) and its share of the
    busy time; None where the trace has no device span for the range (not
    measured)."""
    from torch.autograd import DeviceType

    res = {}
    for name in ENC_BLOCKS:
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.key == f"enc.{name}")
        res[name] = {"ms": us / 1e3 / batches, "share": us / 1e3 / batches / busy} if us else None
    log("  the encoder's blocks on the device (each call's span, ms a batch, share of busy): "
        + ", ".join(f"{k} " + (f"{v['ms']:.3f} ({v['share']:.1%})" if v else "not measured")
                    for k, v in res.items()))
    return res


def extraction_times(dev, W) -> dict:
    """Phase 7a: the bench definition (random weights and mel, batch 64,
    bf16, all layers captured in bf16, decoder on), 8 batches timed on the
    host clock; then the device's busy share under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    arch = W.arch_for("openai/whisper-tiny")
    p = W.params_to(W.cast_params(W.init_whisper(torch.Generator().manual_seed(0), arch),
                                  torch.bfloat16), dev)
    mels = torch.randn(8, ENC_B, N_MELS, 2 * ENC_T, generator=torch.Generator().manual_seed(1),
                       device="cpu").to(dev)

    def run(n):
        for i in range(n):
            W.extract_activations(p, mels[i], arch, compute_dtype=torch.bfloat16,
                                  capture_dtype=torch.bfloat16)

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clips_s = 8 * ENC_B / dt
    res = {"clips_per_s": clips_s, "tokens_per_s_per_layer": clips_s * ENC_T,
           "batch_ms": 1e3 * dt / 8}
    with annotated_blocks(W), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        run(3)
        torch.cuda.synchronize()
    kernels = device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    res["busy_ms"] = busy
    log(f"  extract_activations, batch 64 bf16: {res['batch_ms']:.3f} ms a batch, "
        f"{clips_s:,.1f} clips/s, {res['tokens_per_s_per_layer']:,.0f} activation tokens/s "
        "per layer")
    if busy <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return res
    log(f"  device busy {busy:.3f} ms a batch (profiled run), idle share "
        f"{max(0.0, 1 - busy / res['batch_ms']):.1%} of the unprofiled batch")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / 3:8.4f} ms/batch  {e.count // 3:3d}x  "
            f"{e.key[:90]}")
    res["blocks"] = block_shares(prof, 3, busy)
    return res


def extraction_breakdown(work: Path, dev, W, cfg_mod, cache_mod, ds_mod) -> dict:
    """Phase 7c: where one 64-clip batch of the CLI's extraction spends
    its time, each stage timed alone on the host clock (ending in a
    synchronise): waveforms, log-mel, upload, the encoder's stem and
    layers (CUDA events), the decoder, the device->host copy of the 8
    captured layers, and the f32 widening plus ``.npy`` writes."""
    arch = W.arch_for("openai/whisper-tiny")
    params = W.init_whisper(torch.Generator().manual_seed(0), arch)
    t0 = time.perf_counter()
    p = W.cast_params(W.params_to(params, dev), torch.bfloat16)
    torch.cuda.synchronize()
    res = {"weights_to_card_ms": 1e3 * (time.perf_counter() - t0)}
    ds = ds_mod.SyntheticSpeechDataset(ENC_B, seed=0, device=dev)

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[name] = 1e3 * (time.perf_counter() - t)
        return out

    stage("warm_mel_ms", lambda: ds_mod.SyntheticSpeechDataset(2, seed=9, device=dev)[0])
    waves = stage("waveforms_ms", lambda: np.stack([ds.waveform(i) for i in range(ENC_B)]))
    mel_np = stage("log_mel_ms", lambda: ds_mod.log_mel_spectrogram(waves, device=dev).cpu().numpy())
    mel = stage("upload_ms", lambda: torch.from_numpy(mel_np).bfloat16().to(dev))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad(), W.f32_matmuls():
        W.encoder_forward(p, mel, arch, capture_final_ln=True)  # warm
        torch.cuda.synchronize()
        ev[0].record()
        x = W.encoder_ops.conv_stem(mel, p["encoder"])
        ev[1].record()
        fl = (p["encoder"]["ln_f_g"].float(), p["encoder"]["ln_f_b"].float())
        _, caps, _ = W._fused_encoder_layers(x, p["encoder"], arch, False, fl, torch.bfloat16)
        ev[2].record()
        bos = torch.full((ENC_B, 1), arch.decoder_start_token_id, device=dev)
        _, dec, _ = W.decoder_forward(p, bos, caps[-1], arch, with_mlp=True)
        ev[3].record()
        torch.cuda.synchronize()
    res["stem_ms"] = ev[0].elapsed_time(ev[1])
    res["encoder_layers_ms"] = ev[1].elapsed_time(ev[2])
    res["decoder_ms"] = ev[2].elapsed_time(ev[3])
    copy_stream = torch.cuda.Stream(dev)  # the extraction loop's pinned side-stream copy
    host = stage("to_host_ms", lambda: tuple(cache_mod._start_pull(a.bfloat16(), copy_stream)()
                                             for a in (caps, dec)))
    cache = cache_mod.FeatureCache(work / "bcache", cfg_mod.WhisperConfig(), cfg_mod.DataConfig())

    def write():
        for comp, stack in zip(("encoder", "decoder"), host):
            wide = stack.float()
            for layer in range(stack.shape[0]):
                w = cache.writer(comp, layer)
                w.append(wide[layer].reshape(-1, ENC_D))
                w.finalize(ENC_B)

    stage("widen_and_write_ms", write)
    shutil.rmtree(work / "bcache", ignore_errors=True)
    log("  one 64-clip batch of the CLI's extraction, stage by stage (ms): "
        + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in res.items()))
    return res


def encoder_kernel_times(inp: dict, E, CE) -> dict:
    """Phases 7b and 16b: each encoder kernel on phase 5's (14's) inputs,
    its plain version, its bound and a library yardstick."""
    import torch.nn.functional as F

    lp, mel, enc = inp["lp"], inp["mel"], inp["enc"]
    rows, arows, brows, q, k, v = (inp[n] for n in ("rows", "arows", "brows", "q", "k", "v"))
    n, t = rows.shape[0], ENC_T
    d, f, b, heads, n_mels = (inp[n_] for n_ in ("d", "f", "b", "heads", "n_mels"))
    bf = 2  # bytes of a bf16 value
    wq = torch.cat([lp["attn"]["wq"], lp["attn"]["wk"], lp["attn"]["wv"]], dim=1)
    fl = inp["final_ln"]
    hq, hk, hv = (a.view(b, t, heads, 64).transpose(1, 2) for a in (q, k, v))
    w1, w2 = enc["conv1_w"], enc["conv2_w"]
    res = {}
    res["conv_stem"] = (
        time_ms(lambda: CE.conv_stem_fwd(*inp["stem"])),
        time_ms(lambda: E.conv_stem_plain(*inp["stem"]), iters=5, warmup=1),
        # conv1 at all 2T mel frames, conv2 at the T output frames
        *enc_bound(b * n_mels * 2 * t * bf + (3 * n_mels * d + 3 * d * d + t * d) * bf
                   + b * t * d * bf, 2 * b * t * d * (6 * n_mels + 3 * d)),
        time_ms(lambda: F.conv1d(F.conv1d(mel, w1, enc["conv1_b"], padding=1), w2,
                                 enc["conv2_b"], stride=2, padding=1)),
    )
    res["ln_qkv"] = (
        time_ms(lambda: CE.ln_qkv_fwd(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)),
        time_ms(lambda: E.ln_qkv_plain(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads),
                iters=5, warmup=1),
        *enc_bound(4 * n * d * bf + 3 * d * d * bf, 2 * n * d * 3 * d),
        time_ms(lambda: torch.matmul(rows, wq)),
    )
    core = (time_ms(lambda: CE.self_attention_fwd(q, k, v, heads)),
            time_ms(lambda: E.self_attention_plain(q, k, v, heads), iters=3, warmup=1),
            *enc_bound(4 * n * d * bf, 4 * b * t * t * d, b * heads * t * t),
            time_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv, scale=1.0)))
    res["self_attention"] = core
    res["flash_self_attention"] = (time_ms(lambda: CE.flash_self_attention_fwd(q, k, v, heads)),
                                   *core[1:])
    res["out_proj"] = (
        time_ms(lambda: CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"])),
        time_ms(lambda: E.out_proj_plain(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                iters=5, warmup=1),
        *enc_bound(3 * n * d * bf + d * d * bf, 2 * n * d * d),
        time_ms(lambda: torch.matmul(arows, lp["attn"]["wo"])),
    )
    # the main path's mode: final-LN capture in bf16, no MLP pair
    res["mlp_block"] = (
        time_ms(lambda: CE.mlp_block_fwd(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], False, fl)),
        time_ms(lambda: E.mlp_block_plain(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], False, fl),
                iters=5, warmup=1),
        *enc_bound(3 * n * d * bf + 2 * d * f * bf, 4 * n * d * f),
        time_ms(lambda: torch.matmul(torch.matmul(brows, lp["mlp"]["w1"]), lp["mlp"]["w2"])),
    )
    return res


def encoder_prep_and_parts(inp: dict, CE, lib) -> dict:
    """Phases 7b and 16b, beside the kernel times (which run on weights
    prepared by the earlier phases): the weight preparation's one-off time
    (each kernel layout built from the parameters, not taken from the
    cache), and the launches of LN+QKV, the out-projection and the MLP
    block (in the main path's mode: the final-LN capture in bf16), each
    timed alone, weights prepared."""
    lp, enc, rows, arows, brows = (inp[n] for n in ("lp", "enc", "rows", "arows", "brows"))
    a, m = lp["attn"], lp["mlp"]
    n, d = rows.shape
    f = m["w1"].shape[1]
    prep = {
        "qkv": lambda: CE._build_qkv(a["wq"], a["wk"], a["wv"], a["bq"], a["bv"], lp["ln1_g"],
                                     lp["ln1_b"]),
        "out_proj": lambda: CE._build_out_proj(a["wo"], a["bo"]),
        "mlp": lambda: CE._build_mlp(m["w1"], m["b1"], m["w2"], m["b2"], lp["ln2_g"],
                                     lp["ln2_b"]),
        "stem": lambda: CE._build_stem(enc["conv1_w"], enc["conv1_b"], enc["conv2_w"],
                                       enc["conv2_b"], enc["pos"][:ENC_T]),
    }
    prep_ms = {k: time_ms(fn, iters=5, warmup=1) for k, fn in prep.items()}
    wt, bias, g, bln = CE.qkv_weights(a, lp["ln1_g"], lp["ln1_b"])
    wo, bo = CE.out_proj_weights(a["wo"], a["bo"])
    w1t, b1, w2t, b2, g2, bln2 = CE.mlp_weights(m, lp["ln2_g"], lp["ln2_b"])
    fg, fb = (t.float().contiguous() for t in inp["final_ln"])
    xln, q, k, v, out, out2, xln2, cap = (torch.empty_like(rows) for _ in range(8))
    hid = torch.empty((n, f), dtype=rows.dtype, device=rows.device)
    st = torch.cuda.current_stream().cuda_stream
    calls = {
        "ln_qkv": {
            "ln1": lambda: lib.wst_ln_rows_fwd(rows.data_ptr(), n, d, g.data_ptr(),
                                               bln.data_ptr(), xln.data_ptr(), st),
            "qkv_gemm": lambda: lib.wst_enc_gemm_fwd(
                0, xln.data_ptr(), wt.data_ptr(), n, 3 * d, d, bias.data_ptr(), 0.125, d,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, st)},
        "out_proj": {
            "out_proj_gemm": lambda: lib.wst_enc_gemm_fwd(
                1, arows.data_ptr(), wo.data_ptr(), n, d, d, bo.data_ptr(), 1.0, d,
                out.data_ptr(), None, None, rows.data_ptr(), st)},
        "mlp_block": {
            "ln2": lambda: lib.wst_ln_rows_fwd(brows.data_ptr(), n, d, g2.data_ptr(),
                                               bln2.data_ptr(), xln2.data_ptr(), st),
            "fc1_gemm": lambda: lib.wst_enc_gemm_fwd(
                2, xln2.data_ptr(), w1t.data_ptr(), n, f, d, b1.data_ptr(), 1.0, d,
                hid.data_ptr(), None, None, None, st),
            "fc2_gemm": lambda: lib.wst_enc_gemm_fwd(
                1, hid.data_ptr(), w2t.data_ptr(), n, d, f, b2.data_ptr(), 1.0, d,
                out2.data_ptr(), None, None, brows.data_ptr(), st),
            "final_ln": lambda: lib.wst_ln_rows_fwd(out2.data_ptr(), n, d, fg.data_ptr(),
                                                    fb.data_ptr(), cap.data_ptr(), st)},
    }
    parts_ms = {}
    for kernel, parts in calls.items():
        parts_ms[kernel] = {}
        for name, fn in parts.items():
            check(fn() == 0, f"{name}: launch failed")
            parts_ms[kernel][name] = time_ms(fn)
    log("  weight preparation, one-off ms a layer (built once per parameter tensor, not in "
        "the kernel times): " + ", ".join(f"{k} {v:.4f}" for k, v in prep_ms.items()))
    for kernel, parts in parts_ms.items():
        log(f"  {kernel}'s launches alone ({n} rows, D={d}), ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    return {"prep_ms": prep_ms, "parts_ms": parts_ms}


# ---------------------------------------------------------------------------
# phases 8-10: the coder slice (ReLU SAE, transcoders, crosscoders)
# ---------------------------------------------------------------------------


def coder_inputs(mode: str, n: int, seed: int, dev) -> tuple:
    """Rows, targets (None when the rows are their own target) and weights
    of ``mode`` at whisper-tiny width, drawn on the card from ``seed``."""
    d, dout, k, skip, y_is_x = CODER_MODES[mode]
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = randn(n, d)
    y = None if y_is_x else randn(n, dout)
    p = {"w_enc": randn(d, H, scale=d ** -0.5), "b_enc": randn(H, scale=0.05),
         "w_dec": randn(H, dout, scale=0.05), "b_dec": randn(dout, scale=0.05)}
    if skip:
        p.update(w_skip=randn(d, dout, scale=0.02), b_skip=randn(dout, scale=0.05))
    return x, y, p, k


def coder_ops(CC, p: dict, k):
    b_out = p["b_dec"] + p["b_skip"] if "w_skip" in p else p["b_dec"]
    return CC.operands(p["w_enc"], p["b_enc"], p["w_dec"], b_out, p.get("w_skip"),
                       topk=k is not None)


def check_coder(got, want, k, what: str) -> float:
    """Phase 8's bars; returns the max abs residual error on agreeing rows."""
    torch.cuda.synchronize()
    check(torch.equal(got.xc, want.xc), f"{what}: bf16 rows differ")
    rel = abs(float(got.sq) - float(want.sq)) / float(want.sq)
    check(rel <= 1e-4, f"{what}: sum of squares rel err {rel:.3g} > 1e-4")
    hmax = float(want.hid.float().abs().max())
    if k is not None:
        ok = agree(got.hid, want.hid)
        share = float(ok.float().mean())
        check(share >= 0.999, f"{what}: selection agrees on {share:.4%} of rows")
        hk, hp = got.hid[ok] > 0, want.hid[ok] > 0
        check(int(hk.sum()) == int(hp.sum()) and torch.equal(hk.any(0), hp.any(0)),
              f"{what}: l0/active differ on agreeing rows")
        if bool(ok.all()):
            check(int(got.l0) == int(want.l0) and torch.equal(got.active, want.active),
                  f"{what}: l0/active differ")
    else:
        ok = torch.ones(got.hid.shape[0], dtype=torch.bool, device=got.hid.device)
        for name, a, b in (("l1", got.l1, want.l1), ("hsum", got.hsum, want.hsum)):
            err = float((a - b).abs().max() / b.abs().max())
            check(err <= 1e-4, f"{what}: {name} rel err {err:.3g} > 1e-4")
        share = float((got.active == want.active).float().mean())
        check(share >= 0.999, f"{what}: active equal on {share:.4%} of features")
        rel = abs(int(got.l0) - int(want.l0)) / max(1, int(want.l0))
        check(rel <= 1e-4, f"{what}: l0 rel err {rel:.3g} > 1e-4")
    herr = float((got.hid[ok].float() - want.hid[ok].float()).abs().max())
    check(herr <= 1e-2 * hmax, f"{what}: latent off by {herr:.3g} (max {hmax:.3g})")
    return float((got.resid[ok] - want.resid[ok]).abs().max())


def coder_loss(CC, mode: str, p: dict, x, y, step=None, batch=None):
    """The training loss of ``mode`` through its autograd.Function: the
    sliced entry, or the windowed one when ``step`` is given."""
    k = CODER_MODES[mode][2]
    base = (p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"])
    if mode == "relu_sae":
        if step is None:
            return CC.fused_relu_sae_loss(x, *base, 0.01)[0]
        return CC.fused_relu_sae_loss_indexed(x, step, *base, 0.01, batch)[0]
    if mode == "relu_crosscoder":
        norms = torch.linalg.vector_norm(p["w_dec"], dim=1)
        if step is None:
            return CC.fused_relu_crosscoder_loss(x, *base, norms, 0.01, 4)[0]
        return CC.fused_relu_crosscoder_loss_indexed(x, step, *base, norms, 0.01, 4, batch)[0]
    skip = (p.get("w_skip"), p.get("b_skip"))
    y_is_x = mode == "topk_crosscoder"
    if step is None:
        return CC.fused_transcoder_loss(x, y, *base, *skip, k, "w_skip" in p, y_is_x)[0]
    return CC.fused_transcoder_loss_indexed(x, y, step, *base, *skip, k, batch, "w_skip" in p,
                                            y_is_x)[0]


def coder_grads_close(CC, mode: str, p: dict, x, y, step, batch, what: str) -> None:
    """Gradients through the Function on the card against the same Function
    on the CPU (plain forward), rtol 2e-2.  ReLU modes: >= 99.99% of each
    gradient's elements (a pre within rounding of 0 takes the other sign
    on one side and moves that feature's column)."""
    out = {}
    for key, src, xs, ys in (("card", p, x, y),
                             ("cpu", {n: v.cpu() for n, v in p.items()}, x.cpu(),
                              None if y is None else y.cpu())):
        q = {n: v.clone().requires_grad_(True) for n, v in src.items()}
        coder_loss(CC, mode, q, xs, ys, step, batch).backward()
        out[key] = {n: q[n].grad for n in q}
    for n, want in out["cpu"].items():
        got = out["card"][n].cpu()
        close = torch.isclose(got, want, rtol=2e-2, atol=2e-2 * float(want.abs().max()))
        share = float(close.float().mean())
        need = 0.9999 if CODER_MODES[mode][2] is None else 1.0
        check(share >= need, f"{what}: d{n} agrees with the CPU on {share:.5%} of elements")


def coder_kernel_phase(dev, CC) -> dict:
    """Phase 8: each mode at B=4096, sliced, at a row offset into a larger
    buffer, on a 1,792-row remainder and on ragged 100- and 1,000-row
    windows at an offset, and at B=32768 (the ReLU modes also at phase
    9's 128 rows, sliced and at a row offset), against its plain version;
    gradients; bit-identical losses run to run."""
    b, tail, wide, small = CODER_BATCHES[0], 1792, CODER_BATCHES[-1], 128
    errs = {}
    for i, mode in enumerate(CODER_MODES):
        xbuf, ybuf, p, k = coder_inputs(mode, 2 * b + tail, 30 + i, dev)
        ops = coder_ops(CC, p, k)
        err = 0.0
        wx, wy, wp, _ = coder_inputs(mode, wide, 40 + i, dev)
        windows = [
            ("sliced", xbuf[:b].contiguous(), None if ybuf is None else ybuf[:b].contiguous(),
             0, b, ops),
            ("offset", xbuf, ybuf, b, b, ops), ("remainder", xbuf, ybuf, 2 * b, tail, ops),
            ("ragged", xbuf, ybuf, 37, 100, ops), ("ragged", xbuf, ybuf, b + 300, 1000, ops),
            ("wide", wx, wy, 0, wide, coder_ops(CC, wp, k))]
        if k is None:  # phase 9's batch: the CLI's 128 rows, sliced and as a windowed step
            windows += [("sliced", xbuf[:small].contiguous(), None, 0, small, ops),
                        ("windowed", xbuf, None, 5 * small, small, ops)]
        for what, x, y, off, rows, o in windows:
            got = CC._coder_launch(x, y, off, rows, o, k)
            win = slice(off, off + rows)
            want = CC.coder_forward_plain(x[win], None if y is None else y[win], o, k)
            tag = f"{mode} {what} [{off}, {off + rows})"
            err = max(err, check_coder(got, want, k, tag))
            if k is not None:
                GAPS[tag] = selection_gaps(got.xc, o.we_t, o.b_enc, got.hid, want.hid, k, tag)
            del got, want
        del wx, wy
        a = CC._coder_launch(xbuf, ybuf, b, b, ops, k)
        a2 = CC._coder_launch(xbuf, ybuf, b, b, ops, k)
        torch.cuda.synchronize()
        check(all(u is None or torch.equal(u, v) for u, v in zip(a, a2)),
              f"{mode}: outputs not bit-identical run to run")
        gb = 1024
        gx, gy = xbuf[:2 * gb].contiguous(), None if ybuf is None else ybuf[:2 * gb].contiguous()
        coder_grads_close(CC, mode, p, gx[:gb], None if gy is None else gy[:gb], None, None,
                          f"{mode} sliced")
        coder_grads_close(CC, mode, p, gx, gy, 1, gb, f"{mode} windowed")
        errs[mode] = err
        also = f", on {small} rows sliced and at offset {5 * small}" if k is None else ""
        log(f"  {mode:16s}: agrees sliced, at offset {b}, on the {tail}-row remainder, on 100 "
            f"and 1,000 rows at an offset and at {wide} rows{also} (resid max abs err "
            f"{err:.3g}); loss bit-identical; gradients agree")
    return errs


def coder_config(work: Path) -> Path:
    """tiny_default.yaml with ``activation: relu``, one epoch, on phase 2's
    cache."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"]["activation"] = "relu"
    cfg["training"].update(epochs=1, warmup_steps=200)
    cfg["data"]["cache_dir"] = str(work / "cache")
    cfg["output_dir"] = str(work / "rout")
    cfg["experiment_name"] = "relu_smoke"
    path = work / "relu_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def check_run(run_dir: Path, final: str, want_rows: int, what: str) -> list[float]:
    """A training run's files, its metric rows and a falling loss."""
    for name in (final, "metrics.json", "training_config.json"):
        check((run_dir / name).exists(), f"{what}: {name} missing")
    rows = json.loads((run_dir / "metrics.json").read_text())
    check(len(rows) == want_rows, f"{what}: metrics.json has {len(rows)} rows, not {want_rows}")
    losses = np.array([r["loss"] for r in rows])
    check(bool(np.isfinite(losses).all()), f"{what}: non-finite loss")
    n = max(1, min(100, len(losses) // 10))
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    check(last < first, f"{what}: loss did not fall ({first:.5f} -> {last:.5f})")
    log(f"  {what}: {len(rows)} steps, loss {first:.5f} -> {last:.5f} (means of {n} steps)")
    return [first, last]


def coder_path(work: Path, dev, mix, train_mod, launch_mod, cfg_mod, cache_mod, sae_mod, TC, XC,
               CC, E) -> dict:
    """Phase 9: the ReLU SAE through the CLI, then extraction with the MLP
    pairs, the Skip and TopK transcoders and the TopK and ReLU crosscoders
    through ``whisper_sae_tpu_torch.launch``; launch counts, files, falling
    losses, and each trained family on the card against the CPU."""
    for e in CC.ENTRIES:
        e.launches = 0
    CC.mode_launches.clear()
    CC.plain_calls.clear()
    E.plain_calls.clear()
    res = {"losses": {}}

    t0 = time.perf_counter()
    (trainer,) = train_mod.main(["--config", str(coder_config(work)), "--layer", "encoder:0",
                                 "--no-wandb"]).values()
    res["relu_sae_train_s"] = time.perf_counter() - t0
    relu_dir = trainer.run_dir
    relu_steps = N_ROWS // 128
    res["losses"]["relu_sae"] = check_run(relu_dir, "sae_final.npz", relu_steps + 1,
                                          "ReLU SAE through the CLI")
    rows = json.loads((relu_dir / "metrics.json").read_text())
    check(all(r["sparsity_loss"] > 0 and r["reconstruction_loss"] < r["loss"] for r in rows),
          "ReLU SAE: metrics rows lack the L1 term")

    lcache, lout = work / "lcache", work / "lout"
    t0 = time.perf_counter()
    launch_mod.main(["extract", "--capture-mlp", "--random-whisper", "--dataset", "synthetic",
                     "--max-samples", str(LAUNCH_CLIPS), "--layers-encoder", "0,1,2,3",
                     "--layers-decoder", "", "--cache-dir", str(lcache)])
    res["extract_s"] = time.perf_counter() - t0
    cfg = cfg_mod.ExperimentConfig()
    cache = cache_mod.FeatureCache(lcache / "features", cfg.whisper, cfg.data)
    n_rows = LAUNCH_CLIPS * ENC_T
    for comp in ("encoder", "encoder_mlp_in", "encoder_mlp_out"):
        for layer in range(4):
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim) == (n_rows, D), f"{comp}:{layer}: {meta}")
    check(not cache.has_cache("decoder", 0), "extract wrote a decoder cache")
    log(f"  launch extract --capture-mlp: {LAUNCH_CLIPS} clips in {res['extract_s']:.1f} s, "
        f"4 layer caches and 4 (mlp_in, mlp_out) pairs of {n_rows} rows x {D}")

    epochs, lr = 2, "1e-2"
    steps = n_rows // CODER_B
    common = ["--epochs", str(epochs), "--learning-rate", lr, "--cache-dir", str(lcache),
              "--output-dir", str(lout)]
    jobs = (("skip_transcoder", ["train-transcoder", "--layer-idx", "0"],
             "launch_encoder_transcoder_layer0", "transcoder_final.npz"),
            ("topk_transcoder", ["train-transcoder", "--layer-idx", "0", "--no-skip",
                                 "--experiment-name", "topk"],
             "topk_encoder_transcoder_layer0", "transcoder_final.npz"),
            ("topk_crosscoder", ["train-crosscoder", "--layers", "0,1,2,3"],
             "launch_encoder_crosscoder_l0-1-2-3", "crosscoder_final.npz"),
            ("relu_crosscoder", ["train-crosscoder", "--layers", "0,1,2,3", "--relu",
                                 "--experiment-name", "relu"],
             "relu_encoder_crosscoder_l0-1-2-3", "crosscoder_final.npz"))
    res["job_s"] = {}
    for mode, args, run, final in jobs:
        t0 = time.perf_counter()
        out = launch_mod.main(args + common)
        torch.cuda.synchronize()
        res["job_s"][mode] = time.perf_counter() - t0
        check(out["run_dir"] == str(lout / run) and out["resumed_from"] is None,
              f"{mode}: run {out}")
        res["losses"][mode] = check_run(lout / run, final, epochs * (steps + 1),
                                        f"launch {' '.join(args[:1] + args[3:])}")

    launches = {e.__name__: e.launches for e in CC.ENTRIES}
    by_mode = {f"{entry}[{mode}]": n for (entry, mode), n in sorted(CC.mode_launches.items())}
    log(f"  coder launches: {by_mode}; plain-version calls {dict(CC.plain_calls)}, "
        f"encoder plain calls {dict(E.plain_calls)}")
    windowed = {"relu_sae": relu_steps, "skip_transcoder": epochs * steps,
                "topk_transcoder": epochs * steps, "topk_crosscoder": epochs * steps,
                "relu_crosscoder": epochs * steps}
    for mode, want in windowed.items():
        entry = ("fused_relu_sae_loss" if mode == "relu_sae" else "fused_relu_crosscoder_loss"
                 if mode == "relu_crosscoder" else "fused_transcoder_loss")
        got = CC.mode_launches[(entry + "_indexed", mode)]
        check(got == want, f"{mode}: {got} windowed launches != {want} windowed steps")
        epochs_run = 1 if mode == "relu_sae" else epochs
        check(CC.mode_launches[(entry, mode)] >= epochs_run,
              f"{mode}: {CC.mode_launches[(entry, mode)]} sliced launches, under one an epoch")
    check(sum(CC.plain_calls.values()) == 0 and sum(E.plain_calls.values()) == 0,
          f"plain versions ran on the card: {dict(CC.plain_calls)} {dict(E.plain_calls)}")

    # each trained family on 512 rows: the card against the same model on the CPU
    x_in, _ = cache.load("encoder_mlp_in", 0)
    y_out, _ = cache.load("encoder_mlp_out", 0)
    stack = torch.stack([cache.load("encoder", layer)[0][:512] for layer in range(4)], dim=1)
    rows = gaussian_rows(512, torch.Generator(device=dev).manual_seed(98), mix)
    models = (("relu_sae", lambda d: sae_mod.load_trained_sae(relu_dir, device=d), (rows,)),
              ("skip_transcoder", lambda d: TC.load_trained_transcoder(
                  lout / jobs[0][2], device=d), (x_in[:512], y_out[:512])),
              ("topk_crosscoder", lambda d: XC.load_trained_crosscoder(
                  lout / jobs[2][2], device=d), (stack,)),
              ("relu_crosscoder", lambda d: XC.load_trained_crosscoder(
                  lout / jobs[3][2], device=d), (stack,)))
    for name, load, inputs in models:
        with torch.no_grad():
            card = load(None)(*(a.to(dev) for a in inputs))
            cpu = load("cpu")(*(a.cpu() for a in inputs))
        rel = abs(float(card.loss) - float(cpu.loss)) / float(cpu.loss)
        share = float(agree(card.hidden.cpu(), cpu.hidden).float().mean())
        check(bool(torch.isfinite(card.loss)) and rel < 1e-3 and share >= 0.99,
              f"{name}: card vs CPU on 512 rows: loss rel err {rel:.3g}, {share:.2%} rows agree")
        log(f"  trained {name} on 512 rows, card vs CPU: loss rel err {rel:.2g}, "
            f"{share:.2%} rows select the same features")
    shutil.rmtree(lcache, ignore_errors=True)
    shutil.rmtree(work / "cache", ignore_errors=True)
    res.update(launches=launches, by_mode=dict(CC.mode_launches), relu_trainer=trainer)
    return res


def coder_bound(mode: str, b: int, x, nnz: int) -> tuple[float, str]:
    """Least time of one coder launch: x (and y) read, the bf16 weights and
    biases read, latent, residual and bf16 rows written; encode, the
    decode of this run's nonzero latents and the skip product on the
    tensor cores; the bisection's 32 compares per pre in TopK modes."""
    d, dout, k, skip, y_is_x = CODER_MODES[mode]
    nbytes = (b * d * x.element_size() + (0 if y_is_x else b * dout * 4)
              + (d * H + H * dout + (d * dout if skip else 0)) * 2 + (H + dout) * 4
              + b * H * 2 + b * dout * 4 + b * d * 2 + (H + 1) * 4 + (0 if k else H * 4))
    flops = 2 * b * d * H + 2 * nnz * dout + (2 * b * d * dout if skip else 0)
    return bound(nbytes, flops, (32 if k else 1) * b * H)


def coder_times(dev, CC) -> dict:
    """Phase 10a: each mode at B=128, 4096 and 32768, sliced and at a row
    offset, beside its plain version, its bound and a library yardstick
    (the bf16 encode product, plus the dense decode product in ReLU modes),
    and each of its launches' device ms."""
    res = {}
    for b in CODER_TIME_BATCHES:
        for i, mode in enumerate(CODER_MODES):
            xbuf, ybuf, p, k = coder_inputs(mode, 2 * b, 50 + i, dev)
            ops = coder_ops(CC, p, k)
            x, y = xbuf[:b].contiguous(), None if ybuf is None else ybuf[:b].contiguous()
            out = CC._coder_launch(x, y, 0, b, ops, k)
            nnz = int((out.hid > 0).sum())
            xc, we, wd = x.bfloat16(), p["w_enc"].bfloat16(), p["w_dec"].bfloat16()
            lib = (lambda: torch.matmul(torch.matmul(xc, we), wd)) if k is None else (
                lambda: torch.matmul(xc, we))
            iters = 5 if b > CODER_BATCHES[0] else 20
            sliced = lambda: CC._coder_launch(x, y, 0, b, ops, k)  # noqa: E731
            indexed = lambda: CC._coder_launch(xbuf, ybuf, b, b, ops, k)  # noqa: E731
            res[(mode, b)] = {
                "ms": time_ms(sliced, iters=iters),
                "indexed_ms": time_ms(indexed, iters=iters),
                "plain_ms": time_ms(lambda: CC.coder_forward_plain(x, y, ops, k), iters=3,
                                    warmup=1),
                **dict(zip(("bound_ms", "bound_by"), coder_bound(mode, b, x, nnz))),
                "library_ms": time_ms(lib, iters=iters),
                "nnz_per_row": nnz / b,
            }
            r = res[(mode, b)]
            parts = RELU_PARTS if k is None else SKIP_PARTS if "w_skip" in p else TOPK_PARTS
            r["split_ms"] = launch_split(sliced, parts)
            r["indexed_split_ms"] = launch_split(indexed, parts)
            log(f"  {mode:16s} B={b:5d}: {r['ms']:.4f} ms (at an offset {r['indexed_ms']:.4f}), "
                f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), "
                f"library {r['library_ms']:.4f}, {r['nnz_per_row']:.1f} nonzero latents a row"
                "; launches in ms: " + ", ".join(
                    f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                    for k_, v in r["split_ms"].items()))
            del xbuf, ybuf, x, y, out
    return res


def coder_step_times(work: Path, dev, TC, XC, CT, cfg_mod, relu_trainer, mix) -> dict:
    """Phase 10b: one training step of phase 9's ReLU SAE at the CLI's batch
    128, and of the Skip transcoder, the ReLU crosscoder and the TopK
    crosscoder under AMP (windowed kernel) at the launcher's batch 4096 and
    bench.py's 32768, wall and device busy time, on random rows on the
    card."""
    g = torch.Generator(device=dev).manual_seed(61)
    log(f"  ReLU SAE (D=384, H=3072), batch {relu_trainer.config.batch_size}:")
    res = {"relu_sae_128": step_profile(relu_trainer, gaussian_rows(
        200 * relu_trainer.config.batch_size, g, mix), 200)}
    for b, steps in ((CODER_B, 20), (CODER_BATCHES[-1], 6)):
        n = steps * b
        cfg = cfg_mod.TrainingConfig(batch_size=b, warmup_steps=10, use_amp=True)
        log(f"  Skip transcoder (D=384, H=3072, k=32), batch {b}:")
        tc = CT.TranscoderTrainer(TC.create_transcoder(D, D, H, k=K, use_skip=True, device=dev),
                                  cfg, run_dir=work / "tstep")
        res[f"skip_transcoder_{b}"] = step_profile(
            tc, (torch.randn(n, D, generator=g, device=dev),
                 torch.randn(n, D, generator=g, device=dev)), steps)
        log(f"  ReLU crosscoder (L=4, D=384, S=3072), batch {b}:")
        xc = CT.CrosscoderTrainer(XC.create_crosscoder(D, 4, H, use_topk=False, device=dev), cfg,
                                  run_dir=work / "xstep")
        res[f"relu_crosscoder_{b}"] = step_profile(
            xc, torch.randn(n, 4, D, generator=g, device=dev), steps)
        del xc
        log(f"  TopK crosscoder (L=4, D=384, S=3072, k=32), batch {b}:")
        xc = CT.CrosscoderTrainer(XC.create_crosscoder(D, 4, H, k=K, use_topk=True, device=dev),
                                  cfg, run_dir=work / "kstep")
        res[f"topk_crosscoder_{b}"] = step_profile(
            xc, torch.randn(n, 4, D, generator=g, device=dev), steps)
        del tc, xc
    return res


# ---------------------------------------------------------------------------
# phases 11-13: whisper-large 32x (the blocked encode, kernel C's wide form)
# ---------------------------------------------------------------------------


def large_kernel_phase(dev, cuda_sae, cuda_topk, topk) -> dict:
    """Phase 11; returns the max abs error by kernel."""
    errs = {"fused_topk_encode_blocked": 0.0, "topk_mask_wide": 0.0}
    p = params(40, dev, DL, HL)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    g = torch.Generator(device=dev).manual_seed(41)
    args = (we_t, p["b_enc"], p["b_pre"], K)
    for rows in LARGE_CHECK_ROWS:
        x32 = torch.randn(rows, DL, generator=g, device=dev)
        for x in (x32, x32.bfloat16()):
            xc = (x.float() - p["b_pre"]).bfloat16()
            for out_dtype in (torch.bfloat16, torch.float32):
                what = f"blocked encode rows={rows} x {x.dtype} -> {out_dtype}"
                got = cuda_sae._blocked_encode_launch(x, *args, out_dtype)
                want = cuda_sae.topk_encode_plain(x, *args, out_dtype)
                torch.cuda.synchronize()
                check(got.dtype == out_dtype and got.shape == (rows, HL), f"{what}: output")
                ok = agree(got, want)
                share = float(ok.float().mean())
                check(share >= 0.999, f"{what}: selection agrees on {share:.4%} of rows")
                err = float((got[ok].float() - want[ok].float()).abs().max())
                check(err <= 1e-2 * float(want.float().abs().max()), f"{what}: values off by {err:.3g}")
                errs["fused_topk_encode_blocked"] = max(errs["fused_topk_encode_blocked"], err)
                log(f"  {what}: rows agreeing {share:.4%}, max abs err {err:.3g}")
                # the route selects on the kPre GEMM's pre of these rows
                GAPS[what] = selection_gaps(xc, we_t, p["b_enc"], got, want, K, what)
                del got, want
    a = cuda_sae._blocked_encode_launch(x32, *args, torch.bfloat16)
    check(torch.equal(a, cuda_sae._blocked_encode_launch(x32, *args, torch.bfloat16)),
          "blocked encode: two launches differ")
    del a

    # gradients through _TopKEncode against the CPU, on the rows whose
    # selection the card and the CPU agree on
    x = torch.randn(256, DL, generator=g, device=dev)
    card = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    cpu = cuda_sae.topk_encode_plain(x.cpu(), we_t.cpu(), p["b_enc"].cpu(), p["b_pre"].cpu(), K,
                                     torch.bfloat16)
    ok = agree(card.cpu(), cpu)
    check(float(ok.float().mean()) >= 0.99, f"blocked encode on 256 rows: {int(ok.sum())} agree")
    x = x[ok.to(dev)].contiguous()
    gy = torch.randn(x.shape[0], HL, generator=torch.Generator().manual_seed(42))
    enc = ("w_enc", "b_enc", "b_pre")
    grads_close(lambda q: (cuda_sae.fused_topk_encode(x, q["w_enc"], q["b_enc"], q["b_pre"], K,
                                                      torch.float32) * gy.to(dev)).sum(),
                {n: p[n] for n in enc},
                lambda q: (cuda_sae.fused_topk_encode(x.cpu(), q["w_enc"], q["b_enc"], q["b_pre"], K,
                                                      torch.float32) * gy).sum(),
                enc, "blocked encode")
    log(f"  blocked encode: two launches bit-identical; gradients on {x.shape[0]} agreeing rows "
        "of 256 agree with the CPU (rtol 2e-2)")

    # kernel C's wide form, exact
    pre = torch.randn(1024, HL, generator=g, device=dev)
    pre[:8] = torch.round(pre[:8] * 2) / 2  # exact ties at the threshold
    got = cuda_topk.topk_mask_fwd(pre, K)
    check(torch.equal(got, topk.topk_mask_plain(pre, K)), "topk_mask wide: differs from the plain version")
    check(int((got[8:] > 0).sum(1).min()) == K, "topk_mask wide: not k per row")
    log("  topk_mask wide [1024, 40960] with tie rows: equal to the plain version")
    return errs


def large_config(work: Path) -> Path:
    """tiny_default.yaml at whisper-large-v3's width, expansion 32, k 32,
    batch 8192, AMP, 2 epochs, a dead-feature threshold of 2 steps."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["whisper"]["model_name"] = "openai/whisper-large-v3"
    cfg["sae"].update(expansion_factor=HL // DL, k=K, dead_feature_threshold=2)
    cfg["training"].update(batch_size=BL, use_amp=True, epochs=LARGE_EPOCHS, warmup_steps=2,
                           learning_rate=1e-3)
    cfg["data"]["cache_dir"] = str(work / "lgcache")
    cfg["output_dir"] = str(work / "lgout")
    cfg["experiment_name"] = "large_smoke"
    path = work / "large_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def large_path(work: Path, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk,
               topk) -> dict:
    """Phase 12; returns the trainer, launches by kernel and the losses."""
    path = large_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    check(cfg.whisper.hidden_dim == DL and cfg.sae.get_hidden_dim(DL) == HL, "large config widths")
    cache = cache_mod.FeatureCache(work / "lgcache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0)
    gen = torch.Generator(device=dev).manual_seed(43)
    mix = torch.randn(RANK, DL, generator=gen, device=dev) / RANK ** 0.5
    for _ in range(LARGE_STEPS):
        writer.append(gaussian_rows(BL, gen, mix).cpu().numpy())
    writer.finalize(num_samples=LARGE_STEPS * BL // 1500)
    steps = LARGE_EPOCHS * LARGE_STEPS

    class Trainer(train_mod.SAETrainer):
        """The CLI's trainer with the resample due at the last step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, resample_dead_every=steps, **kw)

    kernels = (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed, cuda_sae.fused_topk_encode)
    for w in kernels:
        w.launches = 0
    cuda_sae.fused_topk_encode.blocked_launches = 0
    cuda_topk.topk_mask_fwd.launches = cuda_topk.topk_mask_fwd.wide_launches = 0
    topk.plain_calls.clear()
    cli_trainer, train_mod.SAETrainer = train_mod.SAETrainer, Trainer
    try:
        t0 = time.perf_counter()
        (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:0",
                                     "--no-wandb"]).values()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        train_mod.SAETrainer = cli_trainer
    launches = {w.__name__: w.launches for w in kernels}
    launches.update(fused_topk_encode_blocked=cuda_sae.fused_topk_encode.blocked_launches,
                    topk_mask=cuda_topk.topk_mask_fwd.launches,
                    topk_mask_wide=cuda_topk.topk_mask_fwd.wide_launches)
    log(f"  CLI trained {steps} steps at batch {BL} in {train_s:.1f} s (cache load and setup "
        f"included); launches {launches}, plain-version calls {dict(topk.plain_calls)}")
    check(launches["fused_topk_encode_blocked"] == steps,
          f"{launches['fused_topk_encode_blocked']} blocked launches != {steps} steps")
    check(launches["fused_sae_loss"] == launches["fused_sae_loss_indexed"] == 0
          and launches["fused_topk_encode"] == 0, "kernels A or B launched at whisper-large width")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    check(trainer.num_resampled_total > 0 and launches["topk_mask_wide"] > 0,
          "the resample did not run through kernel C's wide form")
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    losses = np.array([r["loss"] for r in rows])
    check(len(rows) == steps and bool(np.isfinite(losses).all()), f"metrics: {losses}")
    first, last = float(losses[:3].mean()), float(losses[-3:].mean())
    check(last < first, f"loss did not fall ({first:.5f} -> {last:.5f})")
    with np.load(trainer.run_dir / "sae_final.npz") as z:
        check(z["w_enc"].shape == (DL, HL), "sae_final.npz shapes")
        check(all(bool(np.isfinite(z[n]).all()) for n in z.files), "non-finite parameters")
        check(bool(np.allclose(np.linalg.norm(z["w_dec"], axis=1), 1.0, rtol=1e-5)),
              "decoder rows are not unit norm")
    log(f"  loss {first:.5f} -> {last:.5f} (means of 3 steps), resampled "
        f"{trainer.num_resampled_total} features, decoder rows unit norm")

    # the trained SAE's f32 forward on the card against the CPU
    x = gaussian_rows(64, torch.Generator(device=dev).manual_seed(44), mix)
    with torch.no_grad():
        card = sae_mod.load_trained_sae(trainer.run_dir).eval()(x)
        cpu = sae_mod.load_trained_sae(trainer.run_dir, device="cpu").eval()(x.cpu())
    ok = agree(card.hidden.cpu(), cpu.hidden)
    err = float((card.hidden.cpu()[ok] - cpu.hidden[ok]).abs().max())
    check(float(ok.float().mean()) >= 0.999 and err <= 1e-2 * float(cpu.hidden.abs().max()),
          f"trained SAE, card vs CPU on 64 rows: {int(ok.sum())} rows agree, err {err:.3g}")
    rel = abs(float(card.loss) - float(cpu.loss)) / float(cpu.loss)
    log(f"  trained SAE's f32 forward on 64 rows, card vs CPU: {int(ok.sum())}/64 rows select "
        f"the same features, latent max abs err {err:.3g}, loss rel err {rel:.2g}")
    shutil.rmtree(work / "lgcache", ignore_errors=True)
    return {"trainer": trainer, "launches": launches, "losses": [first, last], "train_s": train_s}


def large_times(work: Path, dev, trainer, cuda_sae, cuda_topk, topk) -> dict:
    """Phase 13: the blocked encode and kernel C's wide form at 8192 rows
    beside their plain versions, bounds and library yardsticks; one
    training step at batch 8192."""
    from whisper_sae_tpu_torch.ops import _build

    p = params(50, dev, DL, HL)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    x = torch.randn(BL, DL, generator=torch.Generator(device=dev).manual_seed(51), device=dev)
    args = (x, we_t, p["b_enc"], p["b_pre"], K, torch.bfloat16)
    xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
    pre = (torch.matmul(xc.float(), w_bf.float()) + p["b_enc"]).contiguous()
    # the select's passes on this pre (it stops at a count of exactly k):
    # a compare and an add an element a pass, and the mask
    chunk = _build.load_library().wst_blocked_chunk_rows()
    passes = torch.cat([topk.cta_threshold(pre[r0:r0 + chunk], K)[2]
                        for r0 in range(0, BL, chunk)]).double()
    select_ops = float(2 * passes.sum() * HL + BL * HL)
    res = {}
    # x, W_enc^T and the biases in, the bf16 latent out; the product and the select
    b_bound = bound(BL * DL * 4 + DL * HL * 2 + (HL + DL) * 4 + BL * HL * 2, 2 * BL * DL * HL,
                    select_ops)
    launch = lambda: cuda_sae._blocked_encode_launch(*args)  # noqa: E731
    split = launch_split(launch, BLOCKED_PARTS)
    chunks = -(-BL // chunk)
    res["fused_topk_encode_blocked"] = {
        "ms": time_ms(launch, iters=10, warmup=2),
        "plain_ms": time_ms(lambda: cuda_sae.topk_encode_plain(*args), iters=2, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), b_bound)),
        "library_ms": time_ms(lambda: torch.mm(xc, w_bf), iters=10, warmup=2),
        # the f32 workspace written and read back, beyond the bound
        "workspace_bytes_ms": 1e3 * 2 * 4 * BL * HL / PEAK_BYTES,
        # device ms a call of each part (its launches a chunk, times the chunks)
        "split_ms": {k_: v * chunks if v is not None else None for k_, v in split.items()},
        "select_passes_mean": float(passes.mean()),
        "select_passes_max": int(passes.max()),
    }
    enc_ms = res["fused_topk_encode_blocked"]["split_ms"]["encode"]
    res["fused_topk_encode_blocked"]["encode_tflops"] = (
        2 * BL * DL * HL / enc_ms / 1e9 if enc_ms else None)
    res["topk_mask_wide"] = {
        "ms": time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K), iters=10, warmup=2),
        "plain_ms": time_ms(lambda: topk.topk_mask_plain(pre, K), iters=2, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), bound(2 * BL * HL * 4, 0, select_ops))),
        "library_ms": time_ms(lambda: torch.topk(pre, K), iters=10, warmup=2),
    }
    for name, r in res.items():
        log(f"  {name:26s} B={BL}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}), library {r['library_ms']:.4f}")
    r = res["fused_topk_encode_blocked"]
    log(f"  blocked encode, device ms a call ({chunks} chunks of {chunk} rows): "
        + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                    for k_, v in r["split_ms"].items())
        + (f"; the product at {r['encode_tflops']:.1f} TFLOP/s" if r["encode_tflops"] else ""))
    log(f"  the select ran {r['select_passes_mean']:.2f} passes a row on average, "
        f"{r['select_passes_max']} at most (of 32); the f32 workspace adds "
        f"{r['workspace_bytes_ms']:.4f} ms of HBM traffic beyond the bound")
    del pre, xc, w_bf, x
    log(f"  one training step at batch {BL} (D={DL}, H={HL}, k={K}, AMP):")
    stepper = type(trainer)(trainer.model, trainer.config, run_dir=work / "lgstep")
    rows = gaussian_rows(3 * BL, torch.Generator(device=dev).manual_seed(52),
                         torch.randn(RANK, DL, generator=torch.Generator(device=dev).manual_seed(53),
                                     device=dev) / RANK ** 0.5)
    res["step"] = step_profile(stepper, rows, 3)
    return res


# ---------------------------------------------------------------------------
# phases 14-18: whisper-large-v3 extraction, out of core, wide crosscoders
# ---------------------------------------------------------------------------


def large_extraction_config(work: Path) -> Path:
    """tiny_default.yaml naming whisper-large-v3, 16 synthetic clips, AMP,
    encoder layers 0 and 31 and decoder layer 31 captured."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["whisper"]["model_name"] = LV3
    cfg["encoder_layers"], cfg["decoder_layers"] = LG_ENC_LAYERS, LG_DEC_LAYERS
    cfg["data"].update(dataset_name="synthetic", max_samples=LG_CLIPS,
                       cache_dir=str(work / "lxcache"))
    cfg["training"]["use_amp"] = True
    cfg["output_dir"] = str(work / "lxout")
    cfg["experiment_name"] = "large_extract_smoke"
    path = work / "large_extract_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def composed_stem(mel: torch.Tensor, enc: dict) -> torch.Tensor:
    """The composed route's conv stem (``encoder_forward``'s torch ops)."""
    import torch.nn.functional as F

    h = F.gelu(F.conv1d(mel, enc["conv1_w"], padding=1) + enc["conv1_b"][None, :, None])
    x = F.gelu(F.conv1d(h, enc["conv2_w"], stride=2, padding=1) + enc["conv2_b"][None, :, None])
    x = x.transpose(1, 2)
    return x + enc["pos"][: x.shape[1]]


def large_extraction_path(work: Path, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E,
                          CE) -> dict:
    """Phase 15; returns launches by kernel, the CLI's clips/s and the
    bf16 weights (kept on the card for phase 16)."""
    path = large_extraction_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    arch = W.arch_for(LV3)
    d = arch.d_model
    reset_enc_launches(CE)
    E.plain_calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_mod.main(["--config", str(path), "--extract-only", "--random-whisper",
                          "--no-wandb"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    log(f"  CLI extracted {LG_CLIPS} whisper-large-v3 clips in {extract_s:.2f} s "
        f"({LG_CLIPS / extract_s:,.2f} clips/s end to end: weights made on the card, mel, the "
        f"32+32-layer forward, transfer, disk); launches {launches}, plain-version calls "
        f"{dict(E.plain_calls)}")
    check(out == {}, "--extract-only trained something")
    batches = -(-LG_CLIPS // train_mod.EXTRACT_BATCH)
    per_layer = arch.encoder_layers * batches
    want = {"conv_stem": 0, "conv_stem_wide": batches, "ln_qkv": per_layer,
            "self_attention": per_layer, "out_proj": per_layer, "mlp_block": per_layer,
            "flash_self_attention": 0}
    check(launches == want, f"large extraction launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"plain versions ran on the card: {E.plain_calls}")

    # the caches against extract_activations on the first 2 clips, on the
    # weights the CLI made (the same generator, on the card)
    cache = cache_mod.FeatureCache(work / "lxcache" / "features", cfg.whisper, cfg.data)
    params = W.init_whisper(torch.Generator(device=dev).manual_seed(cfg.training.seed), arch)
    pb = W.cast_params(params, torch.bfloat16)
    del params
    ds = ds_mod.SyntheticSpeechDataset(LG_CLIPS, seed=cfg.training.seed, n_mels=arch.n_mels,
                                       device=dev)
    mel2 = torch.from_numpy(np.stack([ds[i]["input_features"] for i in range(2)])).to(dev)
    ref = W.extract_activations(pb, mel2, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16)
    for comp, layers, tokens in (("encoder", LG_ENC_LAYERS, ENC_T), ("decoder", LG_DEC_LAYERS, 1)):
        check(not cache.has_cache(comp, 1), f"{comp}:1 was not asked for")
        for layer in layers:
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim, meta.num_samples, meta.dtype)
                  == (LG_CLIPS * tokens, d, LG_CLIPS, "float32"), f"{comp}:{layer} metadata {meta}")
            rows, _ = cache.load(comp, layer)
            check(bool(torch.isfinite(rows).all()), f"{comp}:{layer}: non-finite rows")
            bar_check(rows[:2 * tokens], ref[comp][layer].reshape(-1, d), STACK_BAR,
                      f"{comp}:{layer} first 2 clips vs extract_activations")
            del rows
    log(f"  caches encoder:{LG_ENC_LAYERS} and decoder:{LG_DEC_LAYERS} of {LG_CLIPS} clips x "
        f"{d}: finite, first 2 clips within the stack bar of extract_activations")
    del ref
    shutil.rmtree(work / "lxcache", ignore_errors=True)

    # every layer of the fused route against the card's composed route,
    # from the same input
    enc = pb["encoder"]
    worst = {}
    with torch.no_grad(), W.f32_matmuls():
        mel = mel2.bfloat16()
        x = W.encoder_ops.conv_stem(mel, enc)
        bar_check(x, composed_stem(mel, enc), STACK_BAR, "stem: fused vs composed")
        for i in range(arch.encoder_layers):
            lp = W._layer(enc["layers"], i)
            y = W.encoder_ops.attention_block(x, lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                              arch.num_heads)
            y = W.encoder_ops.mlp_block(y.reshape(-1, d), lp["ln2_g"], lp["ln2_b"],
                                        lp["mlp"]).reshape(x.shape)
            want_l = W._encoder_layer(x, lp, arch.num_heads)[0]
            bar_check(y, want_l, STACK_BAR, f"layer {i}: fused vs composed")
            dd = (y.float() - want_l.float()).abs()
            worst[i] = float(dd.mean() / want_l.float().abs().mean())
            x = y
    torch.cuda.synchronize()
    log(f"  2 clips, every layer fused vs composed from the same input: mean rel err max "
        f"{max(worst.values()):.3g} (layer {max(worst, key=worst.get)}), stack bar 2**-7")
    return {"launches": launches, "cli_clips_per_s": LG_CLIPS / extract_s,
            "extract_s": extract_s, "params": pb}


def large_batch_times(dev, W, pb: dict) -> dict:
    """Phase 16a: bench.py's whisper-large-v3 definition (batch 8, bf16,
    every layer captured in bf16, decoder on), 3 batches on the host clock
    after one warm batch, then 2 under ``torch.profiler``; the bound
    counts the encoder's products and the stem (the one-token decoder is
    under 0.1% of it)."""
    from torch.profiler import ProfilerActivity, profile

    arch = W.arch_for(LV3)
    d, t, n_mels = arch.d_model, ENC_T, arch.n_mels
    mels = torch.randn(3, LG_B, n_mels, 2 * t, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)

    def run(n):
        for i in range(n):
            W.extract_activations(pb, mels[i], arch, compute_dtype=torch.bfloat16,
                                  capture_dtype=torch.bfloat16)

    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    flops = LG_B * (arch.encoder_layers * (24 * t * d * d + 4 * t * t * d)
                    + 2 * t * d * (6 * n_mels + 3 * d))
    res = {"batch_ms": 1e3 * dt / 3, "clips_per_s": 3 * LG_B / dt,
           "bound_ms": 1e3 * flops / PEAK_BF16, "gflop": flops / 1e9}
    with annotated_blocks(W), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        run(2)
        torch.cuda.synchronize()
    kernels = device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    res["busy_ms"] = busy if busy > 0 else None
    log(f"  extract_activations, whisper-large-v3, batch {LG_B} bf16: {res['batch_ms']:.3f} ms a "
        f"batch, {res['clips_per_s']:,.2f} clips/s; operation bound {res['bound_ms']:.3f} ms "
        f"({res['gflop']:,.0f} GFLOP)")
    if busy <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return res
    res["idle_share"] = max(0.0, 1 - busy / res["batch_ms"])
    log(f"  device busy {busy:.3f} ms a batch (profiled run), idle share "
        f"{res['idle_share']:.1%} of the unprofiled batch")
    res["top"] = []
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / 2
        res["top"].append([e.key[:60], ms, e.count // 2])
        log(f"    {ms:8.4f} ms/batch  {e.count // 2:3d}x  {e.key[:90]}")
    res["blocks"] = block_shares(prof, 2, busy)
    res["idle"] = idle_breakdown(prof, 2)
    res.update(batch_split(dev, W, pb, mels[0], arch))
    return res


def batch_split(dev, W, pb: dict, mel: torch.Tensor, arch) -> dict:
    """Phase 16a: the same batch's encoder (stem and 32 fused layers with
    the final-LN captures) and its one-token, 32-layer decoder apart, each
    on the host clock ending in a synchronise, 3 runs after a warm one."""
    def clock(fn, n: int = 3):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n, out

    with torch.no_grad(), W.f32_matmuls():
        mel = mel.bfloat16()
        enc_ms, enc = clock(lambda: W.encoder_forward(pb, mel, arch, capture_final_ln=True,
                                                      capture_dtype=torch.bfloat16))
        bos = torch.full((mel.shape[0], 1), arch.decoder_start_token_id, device=dev)
        dec_ms, _ = clock(lambda: W.decoder_forward(pb, bos, enc[0], arch, with_mlp=True))
    log(f"  the batch's parts on the host clock: encoder_forward {enc_ms:.3f} ms, "
        f"decoder_forward (one token, {arch.decoder_layers} layers) {dec_ms:.3f} ms")
    return {"encoder_ms": enc_ms, "decoder_ms": dec_ms}


def idle_breakdown(prof, batches: int, top: int = 5, min_us: float = 10.0) -> dict:
    """Where the device idles in a profiled window.  The device's
    activities (kernels, copies, memsets) are merged into busy spans; a
    gap is the time between two spans.  Returns the gaps' count and
    total, the longest ``top`` with the host operations that ran during
    each (innermost CPU events, by overlap), and the host operations
    summed over every gap of at least ``min_us`` -- where no recorded
    operation ran, the host was in Python ("unrecorded").  ms a batch."""
    import bisect
    from collections import Counter

    from torch.autograd import DeviceType

    evs = prof.events()
    spans: list[list[float]] = []
    for s0, e0 in sorted((e.time_range.start, e.time_range.end) for e in device_ops(evs)):
        if spans and s0 <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e0)
        else:
            spans.append([s0, e0])
    gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] - a[1] >= min_us]
    all_gap_us = sum(b[0] - a[1] for a, b in zip(spans, spans[1:]))
    starts = [g[0] for g in gaps]
    per_gap = [Counter() for _ in gaps]
    for e in evs:
        if e.device_type != DeviceType.CPU or e.cpu_children:
            continue
        s0, e0 = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(starts, e0) - 1
        while i >= 0 and gaps[i][1] > s0:
            o = min(e0, gaps[i][1]) - max(s0, gaps[i][0])
            if o > 0:
                per_gap[i][e.key] += o
            i -= 1
    total = Counter()
    for (g0, g1), c in zip(gaps, per_gap):
        c["unrecorded"] = max(0.0, (g1 - g0) - sum(c.values()))
        total.update(c)
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])[:top]
    res = {
        "gaps": len(spans) - 1, "gap_ms": all_gap_us / 1e3 / batches,
        "gaps_over_min": len(gaps),
        "gap_over_min_ms": sum(g1 - g0 for g0, g1 in gaps) / 1e3 / batches,
        "host_in_gaps_ms": [[k[:60], v / 1e3 / batches] for k, v in total.most_common(8)],
        "longest": [[(gaps[i][1] - gaps[i][0]) / 1e3,
                     [[k[:40], v / 1e3] for k, v in per_gap[i].most_common(3)]] for i in longest],
    }
    log(f"  device idle: {res['gaps']} gaps, {res['gap_ms']:.3f} ms a batch between the first "
        f"and last device activity; {res['gaps_over_min']} gaps of >= {min_us:g} us hold "
        f"{res['gap_over_min_ms']:.3f} ms a batch; host operations in them (ms a batch): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["host_in_gaps_ms"]))
    for ms, ops in res["longest"]:
        log(f"    gap {ms:.4f} ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ops))
    return res


def out_of_core_config(work: Path) -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["training"].update(epochs=1, warmup_steps=100)
    cfg["data"]["cache_dir"] = str(work / "ocache")
    cfg["output_dir"] = str(work / "oout")
    cfg["experiment_name"] = "ooc_smoke"
    path = work / "ooc_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def out_of_core_path(work: Path, dev, train_mod, cfg_mod, cache_mod, cuda_sae, topk) -> dict:
    """Phase 17: a 2-shard cache trained through the CLI, streamed."""
    path = out_of_core_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    cache = cache_mod.FeatureCache(work / "ocache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0, shard_tokens=1 << 16)
    gen = torch.Generator(device=dev).manual_seed(81)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    for rows in (1 << 16, 1 << 15):  # the writer rolls a shard at an append
        writer.append(gaussian_rows(rows, gen, mix).cpu().numpy())
    meta = writer.finalize(num_samples=3 * (1 << 15) // 1500)
    check(len(meta.shards) == 2, f"the cache has {len(meta.shards)} shards, not 2")
    n = meta.num_tokens
    loaders = []
    real = cache_mod.FeatureCache.get_dataloader

    def spy(self, *a, **kw):
        loaders.append(real(self, *a, **kw))
        return loaders[-1]

    for w in (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed):
        w.launches = 0
    topk.plain_calls.clear()
    cache_mod.FeatureCache.get_dataloader = spy
    try:
        t0 = time.perf_counter()
        (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:0",
                                     "--no-wandb"]).values()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        cache_mod.FeatureCache.get_dataloader = real
    steps = -(-n // cfg.training.batch_size)
    launches = {"fused_sae_loss": cuda_sae.fused_sae_loss.launches,
                "fused_sae_loss_indexed": cuda_sae.fused_sae_loss_indexed.launches}
    (loader,) = loaders
    check(isinstance(loader, cache_mod.PrefetchLoader) and loader.reader.num_rows == n,
          f"the CLI loaded the 2-shard cache as {type(loader).__name__}")
    check(launches == {"fused_sae_loss": steps, "fused_sae_loss_indexed": 0},
          f"streamed launches {launches}, not one sliced launch for each of {steps} steps")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    check(len(trainer._resample_dataset) == 8 * trainer.resample_batch_size,
          f"resample set of {len(trainer._resample_dataset)} rows")
    losses = check_run(trainer.run_dir, "sae_final.npz", steps, "2-shard cache through the CLI")
    log(f"  {n} rows in 2 shards streamed batch by batch: {steps} steps in {train_s:.1f} s "
        f"({n / train_s:,.0f} act/s end to end), launches {launches}, resample set "
        f"{len(trainer._resample_dataset)} rows")
    shutil.rmtree(work / "ocache", ignore_errors=True)
    return {"launches": launches, "steps": steps, "train_s": train_s, "losses": losses}


def wide_coder_path(work: Path, dev, launch_mod, cfg_mod, cache_mod, CC, cuda_topk,
                    topk) -> dict:
    """Phase 18: the crosscoder at S=6144 and the transcoder above
    ``--max-resident-gb``, through the launcher, on synthetic caches."""
    cfg = cfg_mod.ExperimentConfig()
    wcache, wout = work / "wcache", work / "wout"
    cache = cache_mod.FeatureCache(wcache / "features", cfg.whisper, cfg.data)
    n, b, epochs = 8 * CODER_B, CODER_B, 2
    gen = torch.Generator(device=dev).manual_seed(91)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    x0 = gaussian_rows(n, gen, mix)
    x1 = 0.8 * x0 + 0.2 * gaussian_rows(n, gen, mix)
    for layer, rows in ((0, x0), (1, x1)):
        w = cache.writer("encoder", layer)
        w.append(rows.cpu().numpy())
        w.finalize(num_samples=n // 1500)
    wt = torch.randn(D, D, generator=gen, device=dev) / D ** 0.5
    for comp, rows in (("encoder_mlp_in", x0), ("encoder_mlp_out", torch.tanh(x0 @ wt))):
        w = cache.writer(comp, 0, shard_tokens=n // 2)
        for half in rows.split(n // 2):
            w.append(half.cpu().numpy())
        w.finalize(num_samples=n // 1500)
    for e in CC.ENTRIES:
        e.launches = 0
    CC.mode_launches.clear()
    CC.plain_calls.clear()
    cuda_topk.topk_mask_fwd.launches = cuda_topk.topk_mask_fwd.wide_launches = 0
    topk.plain_calls.clear()
    common = ["--batch-size", str(b), "--cache-dir", str(wcache), "--output-dir", str(wout)]
    res = {"losses": {}, "job_s": {}}
    s_wide = 16 * D
    # the ReLU crosscoder's loss rises after its first update in the JAX
    # package as in the port (the decoder starts at norm 0.1 a feature and
    # is renormalised to 1), and at 1e-2 overshoots to ~93 and ends 16
    # steps above its first; so it runs 4 epochs at 1e-3 and compares means
    # of 3 steps (both trajectories: tests/test_torch_port_crosscoder_wide.py
    # run as a script)
    for name, extra, eps in (("topk_crosscoder_s6144", ["--learning-rate", "1e-2"], epochs),
                             ("relu_crosscoder_s6144", ["--relu", "--learning-rate", "1e-3"], 4)):
        t0 = time.perf_counter()
        out = launch_mod.main(["train-crosscoder", "--layers", "0,1", "--expansion-factor", "16",
                               "--experiment-name", name, "--epochs", str(eps), *extra, *common])
        torch.cuda.synchronize()
        res["job_s"][name] = time.perf_counter() - t0
        with np.load(Path(out["run_dir"]) / "crosscoder_final.npz") as z:
            check(z["w_enc"].shape == (2, D, s_wide), f"{name}: w_enc {z['w_enc'].shape}")
        res["losses"][name] = check_run(Path(out["run_dir"]), "crosscoder_final.npz",
                                        eps * (n // b), f"launch train-crosscoder S={s_wide}"
                                        + (" --relu" if "--relu" in extra else ""))
    coder = sum(e.launches for e in CC.ENTRIES)
    res["topk_mask_wide_launches"] = cuda_topk.topk_mask_fwd.wide_launches
    check(coder == 0, f"the coder kernel launched {coder} times at S={s_wide}")
    check(res["topk_mask_wide_launches"] >= epochs * (n // b),
          f"kernel C's wide form launched {res['topk_mask_wide_launches']} times for "
          f"{epochs * (n // b)} TopK steps")
    check(sum(CC.plain_calls.values()) == 0 and sum(topk.plain_calls.values()) == 0,
          f"plain versions ran: {dict(CC.plain_calls)} {dict(topk.plain_calls)}")

    chunks = []
    cls = launch_mod.TranscoderTrainer
    real = cls.train_epoch_out_of_core

    def spy(self, reader, *a, **kw):
        chunks.append(reader.num_rows)
        return real(self, reader, *a, **kw)

    cls.train_epoch_out_of_core = spy
    try:
        t0 = time.perf_counter()
        out = launch_mod.main(["train-transcoder", "--layer-idx", "0", "--max-resident-gb",
                               "0.01", "--experiment-name", "ooc", "--learning-rate", "1e-2",
                               "--epochs", str(epochs), *common])
        torch.cuda.synchronize()
        res["job_s"]["skip_transcoder_out_of_core"] = time.perf_counter() - t0
    finally:
        del cls.train_epoch_out_of_core
    windowed = CC.mode_launches[("fused_transcoder_loss_indexed", "skip_transcoder")]
    check(chunks == [n] * epochs, f"out-of-core epochs over {chunks} rows")
    check(windowed == epochs * (n // b), f"{windowed} windowed launches for {epochs * (n // b)} "
                                         "steps")
    res["losses"]["skip_transcoder_out_of_core"] = check_run(
        Path(out["run_dir"]), "transcoder_final.npz", epochs * (n // b),
        "launch train-transcoder above --max-resident-gb")
    log(f"  crosscoders at S={s_wide}: no coder-kernel launch, kernel C's wide form "
        f"{res['topk_mask_wide_launches']} times; the transcoder streamed {len(chunks)} chunked "
        f"epochs through the paired reader, {windowed} windowed launches")
    shutil.rmtree(wcache, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from whisper_sae_tpu_torch import train as train_mod
        from whisper_sae_tpu_torch import config as cfg_mod
        from whisper_sae_tpu_torch.data import feature_cache as cache_mod
        from whisper_sae_tpu_torch.models import sae as sae_mod
        from whisper_sae_tpu_torch.ops import _build, cuda_sae, cuda_topk, topk
        from whisper_sae_tpu_torch.data import librispeech as ds_mod
        from whisper_sae_tpu_torch.models import whisper as W
        from whisper_sae_tpu_torch.ops import cuda_encoder as CE
        from whisper_sae_tpu_torch.ops import encoder as E
        from whisper_sae_tpu_torch import launch as launch_mod
        from whisper_sae_tpu_torch.models import crosscoder as XC
        from whisper_sae_tpu_torch.models import transcoder as TC
        from whisper_sae_tpu_torch.ops import cuda_coder as CC
        from whisper_sae_tpu_torch.training import coder_trainers as CT
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    check(bool(card), f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    log(f"phase 0: built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  {line.strip()}")
    _build.load_library()

    log("phase 1: kernels against their plain versions")
    errs = kernel_phase(dev, cuda_sae, cuda_topk, topk)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    mix = write_cache(work, dev, cfg_mod, cache_mod)
    wrappers = {
        "fused_sae_loss": cuda_sae.fused_sae_loss,
        "fused_sae_loss_indexed": cuda_sae.fused_sae_loss_indexed,
        "fused_topk_encode": cuda_sae.fused_topk_encode,
        "topk_mask": cuda_topk.topk_mask_fwd,
    }
    for w in wrappers.values():
        w.launches = 0
    log("phases 2-3: train through the CLI, then eval")
    trainer, sae, held_out = main_path(work, dev, mix, train_mod, sae_mod)
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"  launches on the main path: {launches}")
    eval_against_cpu(sae, held_out, sae_mod)
    for name, n in launches.items():
        check(n > 0, f"{name}: no launch on the main path")
    check(launches["fused_sae_loss_indexed"] == EPOCHS * (N_ROWS // 128),
          "windowed kernel A launches != fused steps")

    log("phase 4: times (ms per call; library_ms is a yardstick: the bf16 encode product "
        "for A and B, torch.topk for C -- not equivalents)")
    step_profile(trainer, gaussian_rows(200 * trainer.config.batch_size,
                                        torch.Generator(device=dev).manual_seed(5), mix), 200)
    res = times(dev, cuda_sae, cuda_topk, topk)

    log("phase 5: encoder kernels at whisper-tiny width, 64 clips, against their plain versions")
    enc_errs, enc_inp = encoder_kernel_phase(dev, W, E, CE)

    log("phase 6: extraction through the CLI, then agreement and training from its cache")
    extraction = extraction_path(work, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E, CE)
    replaces = {
        "fused_sae_loss": "src/whisper_sae_tpu/ops/pallas_sae.py:249",
        "fused_sae_loss_indexed": "src/whisper_sae_tpu/ops/pallas_sae.py:424",
        "fused_topk_encode": "src/whisper_sae_tpu/ops/pallas_sae.py:77",
        "topk_mask": "src/whisper_sae_tpu/ops/pallas_topk.py:51",
    }
    kernels = []
    for name in wrappers:
        kernel_a = name.startswith("fused_sae_loss")
        for b in (*BATCHES, A_WIDE_BATCH) if kernel_a else BATCHES:
            ms, plain, bound_ms, by, lib_ms = res[(name, b)]
            log(f"  {name:24s} B={b:5d}: {ms:.4f} ms, plain {plain:.4f}, bound {bound_ms:.4f} "
                f"({by}), library {lib_ms:.4f}")
        ms, plain, bound_ms, by, lib_ms = res[(name, BATCHES[-1])]
        s_ms, s_plain, s_bound, s_by, s_lib = res[(name, BATCHES[0])]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "batch": BATCHES[-1],
            "at_batch_128": {"ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
                             "bound_by": s_by, "library_ms": s_lib},
        }
        if kernel_a:
            w_ms, w_plain, w_bound, w_by, w_lib = res[(name, A_WIDE_BATCH)]
            entry[f"at_batch_{A_WIDE_BATCH}"] = {"ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
                                                 "bound_by": w_by, "library_ms": w_lib}
            entry["split_ms"] = {str(b): res[("split", name, b)]
                                 for b in (*BATCHES, A_WIDE_BATCH)}
        kernels.append(entry)
    log("phase 7: times of the extraction slice (library_ms: torch.matmul for the "
        "projections, the conv1d pair for the stem, scaled_dot_product_attention for the core "
        "-- yardsticks, not equivalents)")
    ext_times = extraction_times(dev, W)
    log(f"  CLI extraction end to end: {extraction['cli_clips_per_s']:,.1f} clips/s")
    ext_times["breakdown_ms"] = extraction_breakdown(work, dev, W, cfg_mod, cache_mod, ds_mod)
    enc_res = encoder_kernel_times(enc_inp, E, CE)
    enc_parts = encoder_prep_and_parts(enc_inp, CE, _build.load_library())
    for name in ENC_WRAPPERS:
        ms, plain, bound_ms, by, lib_ms = enc_res[name]
        log(f"  {name:24s} B={ENC_B:5d}: {ms:.4f} ms, plain {plain:.4f}, bound {bound_ms:.4f} "
            f"({by}), library {lib_ms:.4f}")
        kernels.append({
            "name": name, "route": "cuda", "source": enc_source(name),
            "replaces": ENC_REPLACES[name],
            "launches": extraction["launches"][name], "max_abs_err": enc_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "batch": ENC_B, **prep_entry(name, enc_parts),
        })
    log(f"  extraction: {json.dumps({**ext_times, 'cli_clips_per_s': extraction['cli_clips_per_s']})}")

    log("phase 8: the coder kernel at whisper-tiny width, B=4096, against its plain version")
    coder_errs = coder_kernel_phase(dev, CC)
    log("phase 9: ReLU SAE through the CLI; extract, transcoders and crosscoders through "
        "whisper_sae_tpu_torch.launch")
    path9 = coder_path(work, dev, mix, train_mod, launch_mod, cfg_mod, cache_mod, sae_mod, TC, XC,
                       CC, E)
    log("phase 10: times of the coder slice (library_ms: the bf16 encode product, plus the "
        "dense decode product in ReLU modes -- yardsticks, not equivalents)")
    ctimes = coder_times(dev, CC)
    steps10 = coder_step_times(work, dev, TC, XC, CT, cfg_mod, path9.pop("relu_trainer"), mix)
    for mode in CODER_MODES:
        for entry, replaces, key in (
                ("fused", "src/whisper_sae_tpu/ops/pallas_sae.py:679", "ms"),
                ("fused_indexed", "src/whisper_sae_tpu/ops/pallas_sae.py:1057", "indexed_ms")):
            r = ctimes[(mode, CODER_B)]
            name = {"relu_sae": "fused_relu_sae_loss", "relu_crosscoder": "fused_relu_crosscoder_loss"
                    }.get(mode, "fused_transcoder_loss") + ("_indexed" if "indexed" in entry else "")
            kernels.append({
                "name": f"coder_{entry}[{mode}]", "route": "cuda", "source": CODER_SOURCE,
                "replaces": replaces, "launches": path9["by_mode"].get((name, mode), 0),
                "max_abs_err": coder_errs[mode], "ms": r[key], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "batch": CODER_B,
                **{f"at_batch_{b}": {
                    "ms": ctimes[(mode, b)][key], "plain_ms": ctimes[(mode, b)]["plain_ms"],
                    "bound_ms": ctimes[(mode, b)]["bound_ms"],
                    "bound_by": ctimes[(mode, b)]["bound_by"],
                    "library_ms": ctimes[(mode, b)]["library_ms"]}
                   for b in CODER_TIME_BATCHES if b != CODER_B},
            })
            split = "split_ms" if key == "ms" else "indexed_split_ms"
            kernels[-1]["split_ms"] = {str(b): ctimes[(mode, b)][split]
                                       for b in CODER_TIME_BATCHES}
            if mode == "skip_transcoder":
                kernels[-1]["split_note"] = ("encode and skip_product are both gemm_kernel<3>: "
                                             "the second of a call's two is the skip product")
    for k_ in [k_ for k_ in kernels if k_["name"].startswith("coder_")]:
        check(k_["launches"] > 0, f"{k_['name']}: no launch on the coder path")
    log(f"  coder slice: {json.dumps({'steps': steps10, 'losses': path9['losses'], 'job_s': path9['job_s'], 'relu_sae_train_s': path9['relu_sae_train_s'], 'extract_s': path9['extract_s']})}")

    log("phase 11: whisper-large 32x kernels (D=1280, H=40960) against their plain versions")
    large_errs = large_kernel_phase(dev, cuda_sae, cuda_topk, topk)
    log("phase 12: the whisper-large 32x TopK SAE through the CLI")
    path12 = large_path(work, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk, topk)
    log("phase 13: times at whisper-large 32x (library_ms: the bf16 torch.mm of the encode "
        "product, torch.topk -- yardsticks, not equivalents)")
    ltimes = large_times(work, dev, path12["trainer"], cuda_sae, cuda_topk, topk)
    for name, replaces in (("fused_topk_encode_blocked", "src/whisper_sae_tpu/ops/pallas_sae.py:1392"),
                           ("topk_mask_wide", "src/whisper_sae_tpu/ops/pallas_topk.py:51")):
        r = ltimes[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": BLOCKED_SOURCE if name.endswith("blocked") else SOURCE, "replaces": replaces,
            "launches": path12["launches"][name], "max_abs_err": large_errs[name],
            **{k_: r[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "batch": BL,
        })
        check(kernels[-1]["launches"] > 0, f"{name}: no launch on the whisper-large path")
    kernels[-2]["sources"] = [BLOCKED_SOURCE, GEMM_SOURCE]
    kernels[-2].update({k_: ltimes["fused_topk_encode_blocked"][k_] for k_ in (
        "workspace_bytes_ms", "split_ms", "encode_tflops", "select_passes_mean",
        "select_passes_max")})
    log(f"  whisper-large slice: {json.dumps({'step': ltimes['step'], 'losses': path12['losses'], 'train_s': path12['train_s']})}")

    lg_cli_b = min(LG_CLIPS, train_mod.EXTRACT_BATCH)
    log(f"phase 14: encoder kernels at whisper-large-v3 width against their plain versions, "
        f"{lg_cli_b} clips: the batch every launch of phase 15's CLI run takes")
    lv3 = W.arch_for(LV3)
    one_layer = W.WhisperArch(lv3.d_model, 1, 1, lv3.num_heads, lv3.ffn_dim, n_mels=lv3.n_mels,
                              vocab_size=lv3.vocab_size)
    lg_errs, lg_inp = encoder_kernel_phase(dev, W, E, CE, one_layer, lg_cli_b)
    log("phase 15: whisper-large-v3 extraction through the CLI, then every layer against the "
        "composed route")
    path15 = large_extraction_path(work, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E, CE)
    log("phase 16: times at whisper-large-v3 (library_ms as in phase 7)")
    lg_batch = large_batch_times(dev, W, path15.pop("params"))
    lg_res = encoder_kernel_times(lg_inp, E, CE)
    lg_parts = encoder_prep_and_parts(lg_inp, CE, _build.load_library())
    del lg_inp
    for name in ENC_WRAPPERS:
        ms, plain, bound_ms, by, lib_ms = lg_res[name]
        log(f"  {name:24s} B={lg_cli_b:5d} (large-v3): {ms:.4f} ms, plain {plain:.4f}, bound "
            f"{bound_ms:.4f} ({by}), library {lib_ms:.4f}")
    for entry in kernels:
        name = entry["name"]
        if name in ENC_WRAPPERS and name not in WIDE_FORMS.values():
            ms, plain, bound_ms, by, lib_ms = lg_res[name]
            entry["at_whisper_large_v3"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": lib_ms, "batch": lg_cli_b, "launches": path15["launches"][name],
                "max_abs_err": lg_errs[name], **prep_entry(name, lg_parts)}
    for wide, name in WIDE_FORMS.items():
        ms, plain, bound_ms, by, lib_ms = lg_res[name]
        kernels.append({
            "name": wide, "route": "cuda", "source": ENC_SOURCE, "replaces": ENC_REPLACES[name],
            "launches": path15["launches"][wide], "max_abs_err": lg_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "batch": lg_cli_b, **prep_entry(name, lg_parts),
        })
        check(kernels[-1]["launches"] > 0, f"{wide}: no launch on the whisper-large-v3 path")
    log(f"  whisper-large-v3 extraction: {json.dumps({**lg_batch, 'cli_clips_per_s': path15['cli_clips_per_s'], 'cli_s': path15['extract_s']})}")

    log("phase 17: a 2-shard cache trained through the CLI, out of core")
    ooc = out_of_core_path(work, dev, train_mod, cfg_mod, cache_mod, cuda_sae, topk)
    log("phase 18: train-crosscoder at S=6144 and train-transcoder above --max-resident-gb "
        "through the launcher")
    wide18 = wide_coder_path(work, dev, launch_mod, cfg_mod, cache_mod, CC, cuda_topk, topk)
    log(f"  out of core and wide coders: {json.dumps({'ooc': ooc, 'wide': wide18})}")
    log(f"  rows selecting differently from the plain version (phases 1, 8 and 11): "
        f"{json.dumps({what: rows for what, rows in GAPS.items() if rows})}; "
        f"checked with none: {sorted(what for what, rows in GAPS.items() if not rows)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
