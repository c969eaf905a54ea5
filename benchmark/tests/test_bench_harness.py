"""The harness at a toy size on the CPU: what it finds by name, what it
refuses, the result line, the trace's reduction, and ``correct`` coming
out false with the timed path broken underneath."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from conftest import BENCH, REPO, TOY_TRAIN
from harness import guard
from harness.runner import run_cell
from harness.spec import Spec, load_module
from harness.trace import Trace

CPU = torch.device("cpu")
SEED = 2_900_000_001


def _run(root, cell: str, traced: bool = False, seconds: float = 0.3) -> dict:
    return run_cell(Spec(root), cell, SEED, seconds, traced, CPU, time.perf_counter())


def test_new_config_mix_cell_and_metric_are_found_as_files(toy_root):
    """A later change adds a configuration, a mix, a cell and a metric as
    new files and entries; the harness runs the cell and reports the
    metric without an edit to any file it has."""
    bench = toy_root / "benchmark"
    cfg = json.loads((bench / "configs/toy.json").read_text())
    cfg["sae"]["expansion_factor"] = 4
    (bench / "configs/toy4x.json").write_text(json.dumps(cfg))
    (bench / "traffic/toy-train-b128.json").write_text(json.dumps({**TOY_TRAIN, "batch": 128}))
    (bench / "limits/toy4x.train.json").write_text((bench / "limits/toy.train.json").read_text())
    (bench / "metrics/toy.steps_a_call.py").write_text(
        "def read(run):\n"
        "    if run.trace is not None:\n        return None\n"
        "    return run.window['work'] / run.window['units'] / run.traffic['batch']\n")
    spec = json.loads((toy_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy4x", "source": "https://example.org/toy4x",
                            "file": "benchmark/configs/toy4x.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy4x.train", "config": "toy4x",
                              "traffic": "toy-train-b128", "chips": 1, "why": "toy"})
    spec["end_to_end"].append({"name": "toy.steps_a_call", "unit": "steps", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["toy4x.train"]})
    for m in spec["end_to_end"]:
        if m["name"] == "train_act_per_s":
            m["workloads"].append("toy4x.train")
    (toy_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = _run(toy_root, "toy4x.train")
    assert result["correct"], result["checks"]
    assert result["metrics"]["toy.steps_a_call"]["value"] == 4.0  # a 4-step epoch a call
    assert set(result["metrics"]) == {"train_act_per_s", "setup_s", "toy.steps_a_call"}


@pytest.mark.parametrize("cell", ["toy.train", "toy.extract"])
def test_a_sound_run_and_a_traced_run(toy_root, cell):
    result = _run(toy_root, cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]
    traced = _run(toy_root, cell, traced=True)
    assert traced["correct"] and set(traced["device"]) >= {"busy_s", "window_s"}
    spec = Spec(toy_root)
    names = {m["name"] for m in spec.metrics(spec.cell(cell), traced=True)}
    assert set(traced["metrics"]) <= names and traced["metrics"]  # CPU: no device time to read
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def _frozen_step(self, loss_call, reduce=False):
    """A step that leaves the parameters, moments and counters as they were."""
    loss, aux = loss_call(self.model.params)
    zero = torch.zeros((), device=loss.device)
    return torch.stack([loss.detach(), aux["reconstruction_loss"].detach(),
                        aux["sparsity_loss"].detach(), aux["l0"].float().detach(), zero])


def _half_batch(self, params, sel, step):
    """The batch's first half alone, the mean taken over it."""
    from whisper_sae_tpu_torch.ops.cuda_sae import fused_sae_loss

    b = self._local_batch
    p = params
    loss, l0, active = fused_sae_loss(sel[step * b:step * b + b // 2], p["w_enc"], p["b_enc"],
                                      p["b_pre"], p["w_dec"], p["b_dec"], self.model.k)
    return loss, {"reconstruction_loss": loss, "sparsity_loss": torch.zeros_like(loss),
                  "l0": l0, "active": active}


def _late_offset(original, last: int):
    """The epoch's last step reads the rows of the step before it: a read
    at the wrong offset that only a long epoch reaches."""

    def indexed(self, params, sel, step):
        return original(self, params, sel, step - 1 if step == last else step)

    return indexed


def _answer_altered(original):
    def extract(*args, **kwargs):
        out = original(*args, **kwargs)
        enc = out["encoder"].clone()
        enc[:, [0, 1]] = enc[:, [1, 0]]  # clip 0's captures given as clip 1's
        return {**out, "encoder": enc}

    return extract


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "late_offset",
                                   "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(toy_root, monkeypatch, fault):
    """The whole run, its look for a card skipped, with the timed path
    broken underneath: ``correct`` comes out false on the result line.
    One chip: no exchange between chips to leave out."""
    from whisper_sae_tpu_torch.models import whisper
    from whisper_sae_tpu_torch.training.trainer import SAETrainer

    cell = "toy.extract" if fault == "answer_altered" else "toy.train"
    if fault == "unchanged_state":
        monkeypatch.setattr(SAETrainer, "_step", _frozen_step)
    elif fault == "half_batch":
        monkeypatch.setattr(SAETrainer, "_indexed_loss_fn", _half_batch)
    elif fault == "late_offset":
        monkeypatch.setattr(SAETrainer, "_indexed_loss_fn",
                            _late_offset(SAETrainer._indexed_loss_fn,
                                         TOY_TRAIN["steps_per_epoch"] - 1))
    else:
        monkeypatch.setattr(whisper, "extract_activations",
                            _answer_altered(whisper.extract_activations))
    run = load_module(toy_root / "benchmark/run.py", "bench_toy_run")
    monkeypatch.setattr(run.guard, "require_cards", lambda chips: CPU)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3"])
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is False
    failing = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert failing and all(f"check {k}:" in err.getvalue() for k in result["checks"])
    if fault == "late_offset":  # the first three steps never reach the late rows
        assert failing == ["late_loss"]


def test_jax_loaded_by_a_reader_after_the_window_prints_no_result(toy_root, monkeypatch, tmp_path):
    """A metric reader added later that loads JAX (here a stand-in module
    of that name) runs after the window has closed: the run still prints
    no result and names what it found."""
    stubs = tmp_path / "stubs"
    (stubs / "jax").mkdir(parents=True)
    (stubs / "jax" / "__init__.py").write_text("")
    (toy_root / "benchmark/metrics/toy.loads_jax.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    spec = json.loads((toy_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "toy.loads_jax", "unit": "1", "better": "lower",
                               "bound": 0.01, "source": "host_clock", "workloads": ["toy.train"]})
    (toy_root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.syspath_prepend(str(stubs))
    had = "jax" in sys.modules
    if had:
        monkeypatch.delitem(sys.modules, "jax")
    run = load_module(toy_root / "benchmark/run.py", "bench_toy_run_jax")
    monkeypatch.setattr(run.guard, "require_cards", lambda chips: CPU)
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = run.main(["--workload", "toy.train", "--seed", str(SEED), "--seconds", "0.3"])
        assert sys.modules["jax"].__file__.startswith(str(stubs))
    finally:
        if not had:
            sys.modules.pop("jax", None)
    assert rc != 0
    assert not out.getvalue().strip()
    assert "jax" in err.getvalue()


def _cli(root, *extra, env=None):
    return subprocess.run([sys.executable, str(root / "benchmark/run.py"), "--workload",
                           "tiny8x.train", "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, cwd=root, env=env, timeout=300)


def test_no_card_no_result():
    """A measurement path that finds no card fails: no result line, a
    code other than 0."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _cli(REPO, env=env)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "no CUDA device" in proc.stderr


def test_the_benchmark_files_alone_run_nothing(tmp_path, monkeypatch):
    """A directory holding only ``BENCHMARK.json`` and the benchmark's
    folder has no program to run: the run raises before any result."""
    import shutil

    root = tmp_path / "bare"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    code = ("import sys, time, torch; sys.path.insert(0, 'benchmark');"
            "from harness.runner import run_cell; from harness.spec import Spec;"
            "run_cell(Spec(), 'tiny8x.train', 1, 1.0, False, torch.device('cpu'), time.perf_counter())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, env=env, timeout=300)
    assert proc.returncode != 0 and "whisper_sae_tpu_torch" in proc.stderr
    assert not proc.stdout.strip()


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import types

    assert "whisper_sae_tpu_torch" not in guard.FORBIDDEN
    monkeypatch.setitem(sys.modules, "whisper_sae_tpu_torch_extra", types.ModuleType("x"))
    guard.refuse_forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    with pytest.raises(guard.RefusedRun, match="jaxlib"):
        guard.refuse_forbidden_modules()


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_trace_attribution_busy_and_breakdown():
    """A kernel counts toward the span whose host interval holds its
    launch; busy is the union of device intervals inside the window."""
    events = [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("trainer.step", "user_annotation", 10, 400),
        _x("sae.forward", "user_annotation", 20, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=2),
        _x("cuLaunchKernel", "cuda_driver", 600, 5, correlation=3),
        _x("aten::randperm", "cpu_op", 700, 250),
        _x("fwd_kernel", "kernel", 100, 50, correlation=1),
        _x("bwd_kernel", "kernel", 140, 100, correlation=2),  # overlaps the first
        _x("other_kernel", "kernel", 650, 10, correlation=3),
        _x("outside", "kernel", 1200, 10, correlation=9),  # after the window: left out
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((240 - 100 + 10) * 1e-6)
    assert t.count("trainer.step") == 1 and t.count("sae.forward") == 1
    assert t.device_s("sae.forward") == pytest.approx(50e-6)
    assert t.device_s("trainer.step") == pytest.approx(150e-6)
    assert t.device_s("no.such.span") == 0.0
    b = t.breakdown()
    assert b["device_ops"][0] == ["bwd_kernel", pytest.approx(100e-6)]
    assert b["idle_gaps"][0] == ["bench.window", pytest.approx(410e-6)]
    assert b["idle_gaps"][1] == ["aten::randperm", pytest.approx(340e-6)]


def test_the_memory_readers_read_the_allocators_bytes(toy_root):
    """``train_memory_peak_gb`` reads the run's peak in untraced runs and
    ``memory.train.window_gb`` the window's own rise in traced ones; off
    the card, where the runner records no bytes, both give None."""
    from harness.runner import Run

    spec = Spec(toy_root)
    peak, window = spec.reader("train_memory_peak_gb"), spec.reader("memory.train.window_gb")
    card = {"window_start": 3_000_000_000, "window_peak": 4_250_000_000, "peak": 5_500_000_000}
    profiled = Trace([{"ph": "X", "cat": "user_annotation", "name": "bench.window",
                       "ts": 0.0, "dur": 1e6}])
    untraced = Run({}, {}, {}, memory=dict(card))
    traced = Run({}, {}, {}, trace=profiled, memory=dict(card))
    assert peak.read(untraced) == 5.5 and window.read(untraced) is None
    assert window.read(traced) == 1.25 and peak.read(traced) is None
    assert peak.read(Run({}, {}, {})) is None
    assert window.read(Run({}, {}, {}, trace=profiled)) is None
    cpu = _run(toy_root, "toy.train")
    assert "train_memory_peak_gb" not in cpu["metrics"] and cpu["device"]["memory_peak_bytes"] == 0
