"""The CLI and the launcher under torchrun on 4 ranks, each against one
process: NCCL across four cards (gloo on the CPU with ``--cpu``, at a
smaller size).  The dp ``(4, 1)`` and dp x tp ``(2, 2)`` CLI runs (the
config's ``mesh``; whisper-tiny 8x, AMP, batch 4096, two epochs of 2^16
rows) are held against the one-process run at the AMP bar (rtol 1e-3 a
step); the launcher's extraction on four ranks (64 whisper-tiny clips in
batches of 32, random weights) against one process, bit for bit or within
the stack bar.  Run from the repository root on a host with four cards::

    PYTHONPATH=src python -m whisper_sae_tpu_torch.parallel.mesh_probe
    PYTHONPATH=src python -m whisper_sae_tpu_torch.parallel.mesh_probe --cpu

Its wall times include process starts and the first run's kernel build:
they are not throughput.  Scratch files go under ``build/mesh_probe``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from ..config import DataConfig, WhisperConfig
from ..data.feature_cache import FeatureCache

ROOT = Path(__file__).resolve().parents[3]
WORK = ROOT / "build" / "mesh_probe"


def run(cmd: list[str]) -> tuple[str, float]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=WORK, env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    print(f"$ {' '.join(cmd[:8])} ... rc {p.returncode} in {dt:.1f} s", flush=True)
    if p.returncode:
        print(p.stdout[-4000:], p.stderr[-6000:], flush=True)
        sys.exit(1)
    return p.stdout, dt


def torchrun(n: int, *args: str) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={n}",
            *args]


def main(argv: list[str] | None = None) -> None:
    cpu = "--cpu" in (sys.argv[1:] if argv is None else argv)
    rows_n, batch, clips = ((1 << 12), 512, 8) if cpu else ((1 << 16), 4096, 64)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    if not cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout, flush=True)
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((64, 384)).astype(np.float32) / 8
    rows = (rng.standard_normal((rows_n, 64)).astype(np.float32) @ mix
            + 0.1 * rng.standard_normal((rows_n, 384)).astype(np.float32))
    w = FeatureCache(WORK / "cache" / "features", WhisperConfig(), DataConfig()).writer("encoder", 0)
    w.append(rows)
    w.finalize(num_samples=1)
    dev = ["--device", "cpu"] if cpu else []
    losses = {}
    for name, model in (("single", None), ("dp4", 1), ("tp2x2", 2)):
        cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
        cfg["training"].update(batch_size=batch, epochs=2, warmup_steps=4, learning_rate=1e-3)
        cfg["data"]["cache_dir"] = str(WORK / "cache")
        cfg["output_dir"] = str(WORK / name)
        cfg["mesh"] = {"data": -1, "model": model or 1}
        (WORK / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
        args = ["-m", "whisper_sae_tpu_torch.train", "--config", f"{name}.yaml", "--layer",
                "encoder:0", "--no-wandb", *dev]
        out, dt = run([sys.executable, *args] if model is None else torchrun(4, *args))
        mesh = [l for l in out.splitlines() if l.startswith("Mesh:")]
        run_dir = next((WORK / name).glob("*_encoder_layer0"))
        losses[name] = np.array([r["loss"] for r in json.loads((run_dir / "metrics.json").read_text())])
        print(f"  {name}: {mesh} {len(losses[name])} steps, {dt:.1f} s, loss {losses[name][0]:.5f} -> "
              f"{losses[name][-1]:.5f}", flush=True)
    for name in ("dp4", "tp2x2"):
        rel = float(np.max(np.abs(losses[name] - losses["single"]) / np.abs(losses["single"])))
        print(f"  {name} against one process: max rel loss {rel:.3e}", flush=True)
        if rel > 1e-3:
            sys.exit(f"{name}: losses off the one-process run by {rel:.3e}")
    ext = ["-m", "whisper_sae_tpu_torch.launch", "extract", "--random-whisper", "--dataset",
           "synthetic", "--max-samples", str(clips), "--batch-size", str(clips // 2),
           "--layers-encoder", "0,3", "--layers-decoder", "3", *dev]
    run([sys.executable, *ext, "--cache-dir", "ext1"])
    run(torchrun(4, *ext, "--cache-dir", "ext4"))
    caches = [FeatureCache(WORK / d / "features", WhisperConfig(), DataConfig()) for d in ("ext1", "ext4")]
    for comp, layer in (("encoder", 0), ("encoder", 3), ("decoder", 3)):
        (a, ma), (b, mb) = (c.load(comp, layer) for c in caches)
        same = torch.equal(a, b)
        d = (a.float() - b.float()).abs()
        print(f"  extraction {comp}:{layer}: {ma.num_samples}/{mb.num_samples} clips, bit for bit {same}, "
              f"max rel {float(d.max() / b.float().abs().max()):.3e}", flush=True)
        if not (ma.num_samples == mb.num_samples == clips
                and float(d.max() / b.float().abs().max()) <= 2 ** -4):
            sys.exit(f"extraction {comp}:{layer} differs from the one-process cache")
    print("mesh_probe ok", flush=True)


if __name__ == "__main__":
    main()
