"""A toy copy of the benchmark for CPU runs: the real files, plus a cell
``toy.<kind>`` for each toy definition ``toys/<kind>.json``, small enough
for the CPU and held to a real cell's limits.

A toy definition holds ``config`` (``name``, the ``base`` configuration
file under ``configs/`` and the keys it ``set``s), ``traffic`` (the toy
mix's parameters, with its ``kind``) and ``limits`` (the real cell whose
limits the toy cell borrows).  A kind of work that a later change adds
brings its own toy definition beside its driver; nothing here changes."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TOYS = Path(__file__).resolve().parent / "toys"
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_TRAIN = json.loads((TOYS / "train.json").read_text())["traffic"]


def add_toy(root: Path, kind: str, toy: dict) -> None:
    """The cell ``toy.<kind>`` in the toy tree at ``root``, as new files and
    entries: its configuration (once for toys that share it), its mix
    ``toy-<kind>``, its borrowed limits, and a place in each metric's
    ``workloads`` that lists a cell of the same kind (read from the cells'
    mixes, not their names)."""
    bench, spec_path = root / "benchmark", root / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    c = toy["config"]
    cfg = {**json.loads((bench / "configs" / c["base"]).read_text()), **c["set"],
           "name": c["name"]}
    cfg_path = bench / "configs" / f"{c['name']}.json"
    if cfg_path.exists():  # another toy's: they have to agree
        assert json.loads(cfg_path.read_text()) == cfg, f"toy {kind!r} redefines {c['name']!r}"
    else:
        cfg_path.write_text(json.dumps(cfg))
        spec["configs"].append({"name": c["name"], "source": "https://example.org/toy",
                                "file": f"benchmark/configs/{c['name']}.json", "reduced": [],
                                "why": "toy"})
    assert toy["traffic"]["kind"] == kind, f"toys/{kind}.json's mix is of another kind"
    (bench / "traffic" / f"toy-{kind}.json").write_text(json.dumps(toy["traffic"]))
    if "limits" in toy:
        shutil.copy(bench / "limits" / f"{toy['limits']}.json", bench / "limits" / f"toy.{kind}.json")
    kinds = {w["name"]: json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
             for w in spec["workloads"]}
    spec["workloads"].append({"name": f"toy.{kind}", "config": c["name"], "traffic": f"toy-{kind}",
                              "chips": 1, "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if any(kinds.get(w) == kind for w in m.get("workloads", [])):
            m["workloads"].append(f"toy.{kind}")
    spec_path.write_text(json.dumps(spec))


def make_toy(root: Path, toys: Path = TOYS) -> Path:
    """``root`` holding ``BENCHMARK.json`` and ``benchmark/`` copied from the
    checkout, with a toy cell added for each definition in ``toys``."""
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in sorted(toys.glob("*.json")):
        add_toy(root, path.stem, json.loads(path.read_text()))
    return root


@pytest.fixture
def toy_root(tmp_path) -> Path:
    return make_toy(tmp_path / "checkout")
