"""The port's spans (``utils/profiling.span``) on the CPU: no profiler
range is built while no profiler runs; under ``torch.profiler`` the
trainer's step and the Whisper forward open the ranges the benchmark's
per-layer metrics read, nested as those readers assume; no program span
shares a name with a span the benchmark opens; and the readers'
arithmetic (``benchmark/harness/program_spans.py``) on a made-up trace,
including a trace of a program that opens no span (an older tree).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from whisper_sae_tpu_torch.config import TrainingConfig
from whisper_sae_tpu_torch.models import whisper as W
from whisper_sae_tpu_torch.models.sae import TopKSAE
from whisper_sae_tpu_torch.training.trainer import SAETrainer
from whisper_sae_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"
D, H, K, B, STEPS = 64, 256, 8, 32, 3
LAYERS = 2
TRAIN_SPANS = ("train.step", "train.backward", "train.update", "train.order")
EXTRACT_SPANS = ("extract.call", "encoder.forward", "encoder.attention", "encoder.mlp",
                 "decoder.forward")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(tmp_path) -> SAETrainer:
    """One shuffled fused epoch of ``STEPS`` steps on the CPU."""
    trainer = SAETrainer(TopKSAE(D, H, K, device="cpu"),
                         TrainingConfig(batch_size=B, warmup_steps=0, use_amp=False, seed=3),
                         run_dir=tmp_path / "run")
    rows = torch.from_numpy(np.random.default_rng(0).standard_normal((STEPS * B, D),
                                                                      dtype=np.float32))
    metrics = trainer.train_epochs_fused(rows, epochs=1, shuffle=True)
    assert len(metrics) == STEPS
    return trainer


def _extract() -> dict:
    """A small-arch extraction through the fused route's plain versions:
    D = 128, 2 heads (head dim 64), bf16 compute."""
    arch = W.WhisperArch(d_model=128, encoder_layers=LAYERS, decoder_layers=LAYERS, num_heads=2,
                         ffn_dim=256, n_mels=16, max_source_positions=32, max_target_positions=8,
                         vocab_size=64, decoder_start_token_id=1, eos_token_id=2)
    params = W.init_whisper(torch.Generator().manual_seed(0), arch)
    mel = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    return W.extract_activations(params, mel, arch, compute_dtype=torch.bfloat16,
                                 capture_dtype=torch.bfloat16)


def _ranges(fn, tmp_path) -> dict[str, list[tuple[float, float]]]:
    """``fn()`` under ``torch.profiler`` (CPU) -> the host intervals of
    each ``record_function`` range in its Chrome trace, as the
    benchmark's ``harness/trace.py`` reads them."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out: dict[str, list[tuple[float, float]]] = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    return all(any(s <= a and b <= e for s, e in outer) for a, b in inner)


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) built with no profiler running")


@pytest.mark.parametrize("path", ["train", "extract"])
def test_no_profiler_builds_no_range(tmp_path, monkeypatch, path):
    """Off the profiler every span is the check alone: ``record_function``
    (patched to raise at the name ``profiling`` calls) is never built."""
    monkeypatch.setattr(profiling, "record_function", _refuse)
    if path == "train":
        _train(tmp_path)
    else:
        out = _extract()
        assert out["encoder"].shape[0] == LAYERS and out["decoder"].shape[0] == LAYERS


def test_span_off_is_one_shared_null_context_and_on_a_range():
    off = profiling.span("test.span")
    assert off is profiling.span("test.span")
    with off as entered:
        assert entered is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("test.span"), torch.profiler.record_function)


def test_decorated_span_opens_at_each_call(tmp_path):
    """Decorated while no profiler runs, a function still opens its range
    in every call made under one, and none outside it."""
    @profiling.span("test.decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert f.__name__ == "f"
    got = _ranges(lambda: [f(i) for i in range(3)], tmp_path)
    assert len(got["test.decorated"]) == 3


def test_trainer_spans_under_the_profiler(tmp_path):
    got = _ranges(lambda: _train(tmp_path), tmp_path)
    assert {k: len(got.get(k, [])) for k in TRAIN_SPANS} == {
        "train.step": STEPS, "train.backward": STEPS, "train.update": STEPS, "train.order": 1}
    assert _inside(got["train.backward"], got["train.step"])
    assert _inside(got["train.update"], got["train.step"])
    assert not _inside(got["train.order"], got["train.step"])


def test_extract_spans_under_the_profiler(tmp_path):
    got = _ranges(_extract, tmp_path)
    assert {k: len(got.get(k, [])) for k in EXTRACT_SPANS} == {
        "extract.call": 1, "encoder.forward": 1, "encoder.attention": LAYERS,
        "encoder.mlp": LAYERS, "decoder.forward": 1}
    assert _inside(got["encoder.forward"] + got["decoder.forward"], got["extract.call"])
    assert _inside(got["encoder.attention"] + got["encoder.mlp"], got["encoder.forward"])


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _program_span_names() -> set[str]:
    src = REPO / "src" / "whisper_sae_tpu_torch"
    return {m for p in src.rglob("*.py") for m in re.findall(r'\bspan\("([^"]+)"\)', p.read_text())}


def test_program_spans_are_named_apart_from_the_harness():
    """A shared name would nest a twin inside the harness's range: its
    count doubles and the trace's per-span bisect breaks."""
    program = _program_span_names()
    assert program == set(TRAIN_SPANS + EXTRACT_SPANS)
    harness = {m for p in (BENCH / "drivers").glob("*.py")
               for m in re.findall(r'\(\s*[\w.]+,\s*"\w+",\s*"([\w.]+)"\)', p.read_text())}
    assert {"trainer.step", "sae.forward", "whisper.encoder", "whisper.decoder",
            "check.late"} <= harness
    harness.add(_load(BENCH / "harness" / "trace.py", "bench_trace_for_names").WINDOW)
    assert not program & harness


# -- the readers of the program's spans, on a made-up trace --------------------


@pytest.fixture(scope="module")
def bench():
    """The benchmark's ``Trace`` and its readers, ``benchmark/`` on the path
    as ``benchmark/run.py`` has it (and off it again afterwards)."""
    import sys

    before = set(sys.modules)
    added = str(BENCH) not in sys.path
    if added:
        sys.path.insert(0, str(BENCH))
    trace = _load(BENCH / "harness" / "trace.py", "bench_trace_for_readers")
    readers = {n: _load(BENCH / "metrics" / f"{n}.py", "bench_metric_" + n.replace(".", "_"))
               for n in ("step.backward_ms", "step.update_ms", "idle_share.train.order",
                         "idle_share.extract.encoder", "idle_share.extract.decoder",
                         "extract.kernels_per_batch", "step.bwd_opt_ms")}
    yield SimpleNamespace(Trace=trace.Trace, readers=readers)
    if added:
        sys.path.remove(str(BENCH))
    for name in set(sys.modules) - before:
        if name == "harness" or name.startswith("harness."):
            del sys.modules[name]


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _launched(name, corr, launch_ts, ts, dur):
    return [_x("cudaLaunchKernel", "cuda_runtime", launch_ts, 2, correlation=corr),
            _x(name, "kernel", ts, dur, correlation=corr)]


def _train_events(program_spans: bool) -> list[dict]:
    """A 1000 us window: an order (host 0-200, the device idle), then a
    step 200-800 of forward 210-300, backward 300-600, update 600-790;
    the device busy 250-700; idle 0-250 and 700-1000."""
    ev = [_x("bench.window", "user_annotation", 0, 1000),
          _x("trainer.step", "user_annotation", 200, 600),
          _x("sae.forward", "user_annotation", 210, 90)]
    if program_spans:
        ev += [_x("train.order", "user_annotation", 10, 190),
               _x("train.step", "user_annotation", 201, 598),
               _x("train.backward", "user_annotation", 300, 300),
               _x("train.update", "user_annotation", 600, 190)]
    ev += _launched("fwd", 1, 220, 250, 50)
    ev += _launched("bwd", 2, 310, 300, 300)  # queued behind fwd: 300-600
    ev += _launched("adamw", 3, 620, 600, 100)
    return ev


def _run(bench, events, kind: str):
    return SimpleNamespace(trace=bench.Trace(events), traffic={"kind": kind})


def test_train_readers_on_a_trace(bench):
    run = _run(bench, _train_events(True), "train")
    r = {k: m.read(run) for k, m in bench.readers.items()}
    assert r["step.backward_ms"] == pytest.approx(0.300)
    assert r["step.update_ms"] == pytest.approx(0.100)
    assert r["step.backward_ms"] + r["step.update_ms"] == pytest.approx(r["step.bwd_opt_ms"])
    # idle 0-250 and 700-1000 (550 us); the order's host 10-200 overlaps 190 of it
    assert r["idle_share.train.order"] == pytest.approx(100 * 190 / 550)
    assert r["idle_share.extract.encoder"] is None and r["extract.kernels_per_batch"] is None


def test_extract_readers_on_a_trace(bench):
    """Two calls: each an encoder (host 10-60) whose kernels run 50-300,
    then a decoder (host 60-360) that waits behind them and launches
    two kernels running 360-400; a copy outside every call."""
    ev = [_x("bench.window", "user_annotation", 0, 1000)]
    for c, off in enumerate((0, 500)):
        ev += [_x("extract.call", "user_annotation", off + 5, 400),
               _x("encoder.forward", "user_annotation", off + 10, 50),
               _x("decoder.forward", "user_annotation", off + 60, 300)]
        ev += _launched("enc", 10 * c + 1, off + 20, off + 50, 250)
        ev += _launched("dec", 10 * c + 2, off + 355, off + 360, 20)
        ev += _launched("dec", 10 * c + 3, off + 357, off + 380, 20)
    ev += _launched("copy", 99, 450, 460, 10)
    run = _run(bench, ev, "extract")
    r = {k: m.read(run) for k, m in bench.readers.items()}
    assert r["extract.kernels_per_batch"] == 3.0
    # idle: 0-50, 300-360, 400-460, 470-550, 800-860, 900-1000 = 410 us; the
    # encoders' hosts 10-60 / 510-560 overlap 40 + 40; the decoders' 60-360 /
    # 560-860 overlap 60 + 60
    assert r["idle_share.extract.encoder"] == pytest.approx(100 * 80 / 410)
    assert r["idle_share.extract.decoder"] == pytest.approx(100 * 120 / 410)
    assert r["step.backward_ms"] is None and r["idle_share.train.order"] is None


@pytest.mark.parametrize("kind", ["train", "extract"])
def test_readers_of_a_tree_without_program_spans_read_nothing(bench, kind):
    """The parent tree opens none of the program's spans: every new reader
    gives None, so the result line leaves its metric out."""
    run = _run(bench, _train_events(False), kind)
    new = {k: m.read(run) for k, m in bench.readers.items() if k != "step.bwd_opt_ms"}
    assert new == dict.fromkeys(new)
    assert bench.readers["step.bwd_opt_ms"].read(run) == pytest.approx(0.400)
    assert all(m.read(SimpleNamespace(trace=None, traffic={"kind": kind})) is None
               for m in bench.readers.values())
