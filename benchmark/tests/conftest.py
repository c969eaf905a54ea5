"""A toy copy of the benchmark for CPU runs: the real files, plus a
configuration, two mixes and two cells small enough for the CPU, held to
the whisper-tiny cells' limits."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_TRAIN = {"kind": "train", "batch": 256, "steps_per_epoch": 4,
             "shuffle": True, "schedule_total_steps": 100000, "trace_seconds": 0.2}
TOY_EXTRACT = {"kind": "extract", "batch": 4, "pool": 2, "mel_frames": 64, "mel_scale": 0.5,
               "warm_batches": 1, "trace_seconds": 0.2, "reference_block": 2}


def make_toy(root: Path) -> Path:
    """``root`` holding ``BENCHMARK.json`` and ``benchmark/`` with the toy
    cells ``toy.train`` and ``toy.extract`` added as files and entries."""
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs/whisper-tiny.topk8x.json").read_text())
    cfg.update(name="toy", d_model=128, encoder_layers=1, decoder_layers=1,
               encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=256,
               decoder_ffn_dim=256, num_mel_bins=16, max_source_positions=32,
               max_target_positions=8)
    (bench / "configs/toy.json").write_text(json.dumps(cfg))
    (bench / "traffic/toy-train.json").write_text(json.dumps(TOY_TRAIN))
    (bench / "traffic/toy-extract.json").write_text(json.dumps(TOY_EXTRACT))
    for kind in ("train", "extract"):
        shutil.copy(bench / f"limits/tiny8x.{kind}.json", bench / f"limits/toy.{kind}.json")
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    spec["workloads"] += [{"name": f"toy.{k}", "config": "toy", "traffic": f"toy-{k}",
                           "chips": 1, "why": "toy"} for k in ("train", "extract")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "train" if any(w.endswith(".train") for w in m["workloads"]) else "extract"
            m["workloads"].append(f"toy.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def toy_root(tmp_path) -> Path:
    return make_toy(tmp_path / "checkout")
