"""A kind of work that no cell has yet, added to the toy tree as new files
and new entries alone: a stub driver, its toy definition (which gives
its mix), its limits, its cells.  The harness runs them, a rate reports
in a cell only where the rate's ``workloads`` list names it, and
calibration takes each kind's readings from the kind's own driver."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from conftest import BENCH, TOYS, make_toy
from harness.runner import run_cell
from harness.spec import Spec, load_module

CPU = torch.device("cpu")
SEED = 2_900_000_003
WORK = 7  # the stub's work a call

PROBE_DRIVER = f'''"""A stub kind of work for the CPU: a fixed count of work a call, and
one number under its limit."""


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.attempted = self.failed = 0

    def setup(self):
        pass

    def unit(self):
        self.attempted += 1
        return {WORK}

    def sync(self):
        pass

    def spans(self):
        return []

    def route(self):
        return {{"probe": self.attempted}}

    def release(self):
        pass

    def check(self):
        return {{"gap": 0.5}}
'''
PROBE_READINGS = '''

def readings(drv):
    return {"program": drv.check(), "control": {"gap": 2.0}}
'''
PROBE_TOY = {"config": {"name": "toy-probe", "base": "whisper-tiny.topk8x.json", "set": {}},
             "traffic": {"kind": "probe", "trace_seconds": 0.2}}


def _probe_tree(tmp_path):
    """The toy tree with the kinds ``probe`` (with ``readings``) and
    ``mute`` (without), ``toy.probe`` listed in ``extract_clips_per_s``,
    and ``toy.probe-unlisted`` of the same mix listed nowhere."""
    toys = tmp_path / "toys"
    shutil.copytree(TOYS, toys)
    (toys / "probe.json").write_text(json.dumps(PROBE_TOY))
    root = make_toy(tmp_path / "checkout", toys)
    bench = root / "benchmark"
    (bench / "drivers/probe.py").write_text(PROBE_DRIVER + PROBE_READINGS)
    (bench / "drivers/mute.py").write_text(PROBE_DRIVER)
    for cell in ("toy.probe", "toy.probe-unlisted"):
        (bench / "limits" / f"{cell}.json").write_text(json.dumps({"gap": 1.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "toy.probe-unlisted", "config": "toy-probe",
                              "traffic": "toy-probe", "chips": 1, "why": "toy"})
    for m in spec["end_to_end"]:
        if m["name"] == "extract_clips_per_s":
            m["workloads"].append("toy.probe")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_a_new_kind_is_added_from_new_files_alone(tmp_path):
    root = _probe_tree(tmp_path)
    spec = Spec(root)
    assert spec.traffic(spec.cell("toy.probe")) == PROBE_TOY["traffic"]
    assert all("toy.probe" not in m.get("workloads", [])  # no cell of its kind to follow
               for m in json.loads((root / "BENCHMARK.json").read_text())["per_layer"])

    seconds = 0.3
    listed = run_cell(spec, "toy.probe", SEED, seconds, False, CPU, time.perf_counter())
    assert listed["correct"] and listed["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    assert set(listed["metrics"]) == {"extract_clips_per_s", "setup_s"}
    rate = listed["metrics"]["extract_clips_per_s"]
    # the stub's work over the window's seconds, which end just past ``seconds``
    window_s = WORK * listed["attempted"] / rate["value"]
    assert rate["unit"] == "clips/s" and seconds <= window_s < seconds + 0.5

    unlisted = run_cell(spec, "toy.probe-unlisted", SEED, seconds, False, CPU, time.perf_counter())
    assert unlisted["correct"] and set(unlisted["metrics"]) == {"setup_s"}

    for path in BENCH.rglob("*"):  # the benchmark's files, copied: none edited
        rel = path.relative_to(BENCH)
        if path.is_file() and rel.parts[0] != "tests" and "__pycache__" not in rel.parts:
            assert (root / "benchmark" / rel).read_bytes() == path.read_bytes(), rel


def test_calibration_takes_each_kinds_readings_from_its_driver(tmp_path):
    root = _probe_tree(tmp_path)
    calibrate = load_module(BENCH / "calibrate.py", "bench_calibrate_probe")
    spec = Spec(root)
    for kind in ("probe", "train", "extract"):
        readings = calibrate.readings_for(spec, kind)
        assert readings.__name__ == "readings"
        assert readings.__code__.co_filename == str(root / "benchmark/drivers" / f"{kind}.py")
    probe = calibrate.readings_for(spec, "probe")
    drv = spec.driver("probe").Driver({}, PROBE_TOY["traffic"], SEED, CPU)
    assert probe(drv) == {"program": {"gap": 0.5}, "control": {"gap": 2.0}}
    with pytest.raises(SystemExit, match="'mute'") as refused:
        calibrate.readings_for(spec, "mute")
    assert refused.value.code != 0  # a message: the interpreter exits with 1


@pytest.mark.parametrize("cell,faults", [("toy.train", {"half", "offset"}),
                                         ("toy.extract", {"answer"})])
def test_the_drivers_readings_at_a_toy_size(toy_root, cell, faults):
    """The training and extraction drivers' ``readings`` through
    ``readings_for``, as ``calibrate.py`` runs them: the program within
    the borrowed limits, the control past one of them."""
    calibrate = load_module(BENCH / "calibrate.py", "bench_calibrate_toy")
    spec = Spec(toy_root)
    c = spec.cell(cell)
    traffic, limits = spec.traffic(c), spec.limits(c)
    readings = calibrate.readings_for(spec, traffic["kind"])
    out = readings(spec.driver(traffic["kind"]).Driver(spec.config(c), traffic, SEED, CPU))
    assert set(out) == {"program", "control", *faults}
    assert all(out["program"][k] <= v for k, v in limits.items()), out["program"]
    assert any(out["control"][k] > v for k, v in limits.items()), out["control"]
