"""The port stands alone: it imports no jax and nothing of whisper_sae_tpu,
and its entry points run on the card unless asked for the CPU."""

from __future__ import annotations

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, importlib.util, pkgutil, sys
import whisper_sae_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "whisper_sae_tpu",
                                    "datasets"))
need = {"launch", "models.transcoder", "models.crosscoder", "training.coder_trainers",
        "ops.cuda_coder", "models.hooks", "decoder_analysis.logit_lens",
        "decoder_analysis.cross_attention", "utils.wavio", "utils.metrics",
        "utils.profiling", "analysis.feature_viz", "analysis.coactivation",
        "analysis.audio_extraction", "analysis.auto_label", "analysis.dashboard",
        "causal.patching", "parallel", "parallel.mesh", "parallel.multihost",
        "parallel.sharding", "parallel.tp_topk", "parallel.tp_step", "parallel.extraction"}
missing = sorted(n for n in need if pkg.__name__ + "." + n not in names)
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 50 else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_import():
    root = REPO / "src" / "whisper_sae_tpu_torch"
    for path in [*root.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import whisper_sae_tpu ",
                                     "from whisper_sae_tpu.", "from whisper_sae_tpu import")), (
                f"{path}: {s}")


def test_entry_points_need_the_card_unless_asked(monkeypatch, tmp_path):
    from whisper_sae_tpu_torch import launch
    from whisper_sae_tpu_torch import train as cli
    from whisper_sae_tpu_torch.config import SAEConfig
    from whisper_sae_tpu_torch.models.sae import TopKSAE, create_sae
    from whisper_sae_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopKSAE(32, 128, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_sae(SAEConfig(k=4, expansion_factor=4), input_dim=32)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", str(tmp_path / "missing.yaml"), "--no-wandb"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.transcribe_job(random_whisper=True, num_synthetic=1)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert TopKSAE(32, 128, 4, device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from whisper_sae_tpu_torch.ops import cuda_sae
    from whisper_sae_tpu_torch.ops.cuda_topk import topk_mask_fwd

    meta = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        topk_mask_fwd(meta, 2)
    w = torch.empty((64, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sae.fused_topk_encode(meta, w, torch.empty(128, device="meta"),
                                   torch.empty(64, device="meta"), 2)


def test_no_launch_environment_means_the_single_device_path(monkeypatch):
    """Without torchrun's environment nothing initialises a process group
    and this process is the primary one; under it each rank's card is
    ``cuda:LOCAL_RANK``."""
    from whisper_sae_tpu_torch.parallel import multihost
    from whisper_sae_tpu_torch.utils.device import resolve_device

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not multihost.launched()
    assert multihost.initialize_if_needed() is False
    assert multihost.is_primary()
    with pytest.raises(ValueError, match="world size and this rank"):
        multihost.initialize_if_needed(num_processes=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost.launched()
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cpu").type == "cpu"
