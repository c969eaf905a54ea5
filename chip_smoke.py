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
   (atol 1e-2 * max); gradients at rtol 2e-2.
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

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  Scratch files go under ``build/``.
"""

from __future__ import annotations

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
N_ROWS = (1 << 18) + 64
EPOCHS = 3
RANK = 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores (also used here for the bisection's int compares), HBM3
PEAK_BF16, PEAK_ALU, PEAK_BYTES = 989e12, 67e12, 3.35e12
SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/sae_kernels.cu"
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")


class SmokeFailure(RuntimeError):
    pass


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


def params(seed: int, dev) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    p = {
        "w_enc": torch.randn(D, H, generator=g) * 0.05,
        "b_enc": torch.randn(H, generator=g) * 0.05,
        "b_pre": torch.randn(D, generator=g) * 0.05,
        "w_dec": torch.randn(H, D, generator=g) * 0.05,
        "b_dec": torch.randn(D, generator=g) * 0.05,
    }
    return {k: v.to(dev) for k, v in p.items()}


def agree(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows whose selections match."""
    return ((a > 0) == (b > 0)).all(dim=1)


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


def kernel_phase(dev, cuda_sae, cuda_topk, topk) -> dict:
    errs: dict[str, float] = {}
    for b in BATCHES:
        p = params(b, dev)
        gen = torch.Generator().manual_seed(b + 1)
        x = torch.randn(b, D, generator=gen).to(dev)
        buf = torch.randn(3 * b, D, generator=gen).to(dev)
        we_t = cuda_sae._bf16_t(p["w_enc"])
        wd = p["w_dec"].bfloat16()
        b_out = p["b_dec"] + p["b_pre"]

        # kernel A, sliced and at a row offset into an epoch buffer
        for what, data, off in (("fused_sae_loss", x, 0), ("fused_sae_loss_indexed", buf, b)):
            got = cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"], p["b_pre"], wd, b_out, K)
            want = cuda_sae.fused_sae_loss_plain(data[off:off + b], we_t, p["b_enc"], p["b_pre"],
                                                 wd, b_out, K)
            torch.cuda.synchronize()
            ok = agree(got[3], want[3])
            share = float(ok.float().mean())
            check(share >= 0.999, f"{what} B={b}: selection agrees on {share:.4%} of rows")
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
    return errs


# ---------------------------------------------------------------------------
# phases 2-3: the main path through the CLI, then eval
# ---------------------------------------------------------------------------


def gaussian_rows(n: int, gen: torch.Generator, mix: torch.Tensor) -> torch.Tensor:
    """Gaussian rows whose covariance is mostly of rank ``RANK`` (plus
    isotropic noise), so a k=32 SAE has structure to find."""
    z = torch.randn(n, RANK, generator=gen, device=mix.device)
    return z @ mix + 0.1 * torch.randn(n, D, generator=gen, device=mix.device)


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


def step_profile(trainer, dev, mix: torch.Tensor, steps: int = 200) -> None:
    """Where a training step's time goes: ``steps`` fused-epoch steps of the
    trained trainer at batch 128, timed on the host clock without the
    profiler, then once under ``torch.profiler`` for the device's busy
    time per step and its heaviest operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = gaussian_rows(steps * trainer.config.batch_size, torch.Generator(device=dev).manual_seed(5), mix)
    trainer.train_epoch_fused(rows, shuffle=False)  # warm
    t0 = time.perf_counter()
    trainer.train_epoch_fused(rows, shuffle=False)  # ends with its one metrics fetch
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch_fused(rows, shuffle=False)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"  step at batch {trainer.config.batch_size}: {wall_ms:.3f} ms wall "
        f"({trainer.config.batch_size / wall_ms * 1e3:,.0f} act/s)")
    if busy_ms <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return
    log(f"  device busy {busy_ms:.3f} ms per step (profiled run), idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.1%} of the unprofiled step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.4f} ms/step  {e.count // steps:3d}x  "
            f"{e.key[:90]}")


def times(dev, cuda_sae, cuda_topk, topk) -> dict:
    res: dict = {}
    for b in BATCHES:
        p = params(7, dev)
        x = torch.randn(b, D, generator=torch.Generator().manual_seed(8)).to(dev)
        buf = torch.cat([torch.randn_like(x), x, torch.randn_like(x)])
        we_t = cuda_sae._bf16_t(p["w_enc"])
        wd, b_out = p["w_dec"].bfloat16(), p["b_dec"] + p["b_pre"]
        xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
        pre = (torch.matmul(xc.float(), w_bf.float()) + p["b_enc"]).contiguous()
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
            a_ms = time_ms(lambda: cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"],
                                                               p["b_pre"], wd, b_out, K))
            res[(name, b)] = (a_ms, a_plain, *a_bound, lib_gemm)

        b_bytes = b * D * 4 + D * H * 2 + (H + D) * 4 + b * H * 2
        b_bound = bound(b_bytes, 2 * b * D * H, 32 * b * H)
        b_ms = time_ms(lambda: cuda_sae._topk_encode_launch(x, we_t, p["b_enc"], p["b_pre"], K,
                                                            torch.bfloat16))
        b_plain = time_ms(lambda: cuda_sae.topk_encode_plain(x, we_t, p["b_enc"], p["b_pre"], K,
                                                             torch.bfloat16), iters=5, warmup=1)
        res[("fused_topk_encode", b)] = (b_ms, b_plain, *b_bound, lib_gemm)

        c_bound = bound(2 * b * H * 4, 0, 32 * b * H)
        c_ms = time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K))
        c_plain = time_ms(lambda: topk.topk_mask_plain(pre, K), iters=5, warmup=1)
        c_lib = time_ms(lambda: torch.topk(pre, K))
        res[("topk_mask", b)] = (c_ms, c_plain, *c_bound, c_lib)
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
    shutil.rmtree(work / "cache", ignore_errors=True)

    log("phase 4: times (ms per call; library_ms is a yardstick: the bf16 encode product "
        "for A and B, torch.topk for C -- not equivalents)")
    step_profile(trainer, dev, mix)
    res = times(dev, cuda_sae, cuda_topk, topk)
    replaces = {
        "fused_sae_loss": "src/whisper_sae_tpu/ops/pallas_sae.py:249",
        "fused_sae_loss_indexed": "src/whisper_sae_tpu/ops/pallas_sae.py:424",
        "fused_topk_encode": "src/whisper_sae_tpu/ops/pallas_sae.py:77",
        "topk_mask": "src/whisper_sae_tpu/ops/pallas_topk.py:51",
    }
    kernels = []
    for name in wrappers:
        for b in BATCHES:
            ms, plain, bound_ms, by, lib_ms = res[(name, b)]
            log(f"  {name:24s} B={b:5d}: {ms:.4f} ms, plain {plain:.4f}, bound {bound_ms:.4f} "
                f"({by}), library {lib_ms:.4f}")
        ms, plain, bound_ms, by, lib_ms = res[(name, BATCHES[-1])]
        s_ms, s_plain, s_bound, s_by, s_lib = res[(name, BATCHES[0])]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "batch": BATCHES[-1],
            "at_batch_128": {"ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
                             "bound_by": s_by, "library_ms": s_lib},
        })
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
