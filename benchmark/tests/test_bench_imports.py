"""What a run loads, in fresh processes: no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``whisper_sae_tpu`` (compared whole,
so the port's ``whisper_sae_tpu_torch`` passes), and a reference that
loads nothing of the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_sae_tpu")


def _top_level_modules(code: str) -> set[str]:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    script = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    """Everything a run of each cell imports: the harness, the drivers and
    the program modules they load, the readers, the references."""
    code = """
from harness.runner import program_on_path
from harness.spec import Spec
program_on_path()
spec = Spec()
for w in spec.data["workloads"]:
    cell = spec.cell(w["name"])
    drv = spec.driver(spec.traffic(cell)["kind"])
    for traced in (False, True):
        for m in spec.metrics(cell, traced):
            spec.reader(m["name"])
import whisper_sae_tpu_torch.training.trainer, whisper_sae_tpu_torch.models.whisper
import whisper_sae_tpu_torch.ops.cuda_sae, whisper_sae_tpu_torch.ops.cuda_encoder
import run, calibrate
"""
    loaded = _top_level_modules(code)
    assert "whisper_sae_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    """Every module under ``reference/``, ``counts/`` and ``inputs/``, found
    by glob: a new kind's reference is held to this as it is added."""
    modules = sorted(f"{d}.{p.stem}" for d in ("reference", "counts", "inputs")
                     for p in (BENCH / d).glob("*.py") if p.stem != "__init__")
    assert {"reference.sae_train", "reference.whisper_extract", "counts.sae",
            "inputs.whisper"} <= set(modules)
    loaded = _top_level_modules("import " + ", ".join(modules))
    assert not loaded & {"whisper_sae_tpu_torch", *FORBIDDEN}
