"""The research loop of the port's launcher on the CPU, against the JAX
launcher (``launcher/launch.py``) on the same caches and checkpoints: the
``train`` job (one layer and ``--all-layers``), its resume after a crash,
the restart supervisor (``--supervise``), ``analyze`` for the three coder
families, ``causal-validate`` for both components, and the CLI's
``--profile``.

What the two packages draw differently is pinned, as in
``tests/test_torch_port_out_of_core.py``: the initial SAE parameters
(the same numpy draws patched into both ``create_sae``) and the order of
each epoch (a numpy permutation keyed by the step the epoch starts at).
Whisper weights for the causal job are the JAX package's random ones,
patched into the port's ``init_whisper``.

Bars: the f32 loss trajectory at rtol 2e-4 and final parameters at atol
2e-4 (``tests/test_torch_port_trainer.py``'s); kill-and-resume bit for
bit against an uninterrupted run; ``summary.json``'s feature order equal
and its values at rtol 1e-5; the causal KL within 1e-4 relative, token
agreement equal.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu.config import DataConfig as JDataConfig
from whisper_sae_tpu.config import WhisperConfig as JWhisperConfig
from whisper_sae_tpu.data.feature_cache import FeatureCache as JFeatureCache
from whisper_sae_tpu.models import sae as jsae
from whisper_sae_tpu.models import whisper as JW
from whisper_sae_tpu.training import trainer as jtrainer
from whisper_sae_tpu.utils.checkpoint import save_pytree as jsave_pytree
from whisper_sae_tpu_torch import launch
from whisper_sae_tpu_torch import train as cli
from whisper_sae_tpu_torch.models import sae as tsae
from whisper_sae_tpu_torch.models import whisper as TW
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

REPO = Path(__file__).resolve().parent.parent
D, SAMPLES, FRAMES = 64, 6, 50
ROWS = SAMPLES * FRAMES
B = 64  # 4 full steps and a 44-row remainder an epoch
TRAIN = dict(expansion_factor=4, k=8, batch_size=B, learning_rate=1e-3, epochs=2,
             warmup_steps=2, use_amp=False, checkpoint_every=1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jlaunch():
    spec = importlib.util.spec_from_file_location("_jax_launcher", REPO / "launcher" / "launch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(seed: int, n: int) -> np.ndarray:
    """Rows a dictionary of 24 directions explains, plus noise."""
    rng = np.random.default_rng(seed)
    atoms = rng.standard_normal((24, D)).astype(np.float32)
    codes = rng.exponential(1.0, (n, 24)) * (rng.random((n, 24)) < 0.15)
    return (codes @ atoms + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory) -> Path:
    """A cache in the JAX format: encoder layers 0 and 1 and the layer-0
    (mlp_in, mlp_out) pair (6 clips of 50 frames), decoder layer 0 (one
    row a clip), a synthetic extraction log and transcripts."""
    root = tmp_path_factory.mktemp("research") / "cache"
    cache = JFeatureCache(root / "features", JWhisperConfig(), JDataConfig())
    for i, comp in enumerate(("encoder", "encoder", "encoder_mlp_in", "encoder_mlp_out")):
        cache.save(_rows(i, ROWS), comp, 1 if i == 1 else 0, num_samples=SAMPLES)
    cache.save(_rows(9, SAMPLES), "decoder", 0, num_samples=SAMPLES)
    features = root / "features"
    (features / "extraction_log.json").write_text(json.dumps(
        {"dataset": "synthetic", "seed": 5, "max_samples": SAMPLES}))
    words = ["alpha", "beta", "gamma", "delta"]
    (features / "transcripts.json").write_text(json.dumps(
        {str(i): f"{words[i % 4]} {words[(i + 1) % 4]} clip{i}" for i in range(SAMPLES)}))
    return root


def _sae_params(d: int, seed: int) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in jsae.TopKSAE(d, 4 * d, 8, seed=seed).params.items()}


def _pin(monkeypatch) -> None:
    """The same initial parameters (by input width) and epoch orders in
    both packages' train jobs."""

    def perm_pinned(base):
        class Pinned(base):
            def train_epoch_fused(self, data, shuffle=True, seed=None, perm=None, **kw):
                n = (data[0] if isinstance(data, tuple) else data).shape[0]
                perm = np.random.default_rng(self.global_step).permutation(n)
                return super().train_epoch_fused(data, shuffle=shuffle, seed=seed, perm=perm, **kw)
        return Pinned

    monkeypatch.setattr(jtrainer, "SAETrainer", perm_pinned(jtrainer.SAETrainer))
    monkeypatch.setattr(launch, "SAETrainer", perm_pinned(launch.SAETrainer))
    real_j, real_t = jsae.create_sae, launch.create_sae

    def jcreate(cfg, input_dim, seed=0):
        sae = real_j(cfg, input_dim, seed=seed)
        sae.params = {k: jnp.asarray(v) for k, v in _sae_params(input_dim, 7).items()}
        return sae

    def tcreate(cfg, input_dim, seed=0, device=None):
        sae = real_t(cfg, input_dim, seed=seed, device=device)
        sae.load_params(params_from_jax(_sae_params(input_dim, 7)))
        return sae

    monkeypatch.setattr(jsae, "create_sae", jcreate)
    monkeypatch.setattr(launch, "create_sae", tcreate)


def _same_run(got: Path, want: Path, steps: int) -> None:
    tl = [r["loss"] for r in json.loads((got / "metrics.json").read_text())]
    jl = [r["loss"] for r in json.loads((want / "metrics.json").read_text())]
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    with np.load(got / "sae_final.npz") as z, np.load(want / "sae_final.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
        for k in z.files:
            np.testing.assert_allclose(z[k], zj[k], atol=2e-4, err_msg=k)
    files = sorted(p.name for p in got.iterdir())
    assert files == sorted(p.name for p in want.iterdir()) == [
        "checkpoint_epoch1.npz", "checkpoint_epoch2.npz", "final.npz", "metrics.json",
        "sae_final.npz", "sae_final.pt", "training_config.json"]
    tc, jc = (json.loads((p / "training_config.json").read_text()) for p in (got, want))
    tc.pop("finished_at"), jc.pop("finished_at")
    assert tc == jc


@pytest.mark.parametrize("all_layers", [False, True], ids=["one_layer", "all_layers"])
def test_train_job_matches_jax(cache_dir, tmp_path, monkeypatch, jlaunch, all_layers):
    _pin(monkeypatch)
    common = dict(cache_dir=cache_dir, **TRAIN)
    if all_layers:
        layers = dict(layers_encoder="0,1", layers_decoder="0")
        want = jlaunch.train_all_layers(output_dir=tmp_path / "jax", **layers, **common)
        got = launch.train_all_layers(output_dir=tmp_path / "port", device="cpu", **layers,
                                      **common)
    else:
        want = [jlaunch.train_sae(layer_idx=1, output_dir=tmp_path / "jax", **common)]
        got = [launch.train_sae(layer_idx=1, output_dir=tmp_path / "port", device="cpu",
                                **common)]
    assert [(r["component"], r["layer_idx"], r["num_tokens"]) for r in got] == \
        [(r["component"], r["layer_idx"], r["num_tokens"]) for r in want]
    for g, w in zip(got, want):
        steps = 2 * -(-g["num_tokens"] // B)
        assert g["resumed_from"] is None
        _same_run(Path(g["run_dir"]), Path(w["run_dir"]), steps)
    # the port's run loads as a trained SAE in either package
    sae = tsae.load_trained_sae(got[0]["run_dir"], device="cpu")
    assert (sae.k, sae.hidden_dim) == (8, 4 * D)


def _train_cli(cache_dir, out: Path, *extra: str) -> list[str]:
    return ["train", "--layer-idx", "0", "--expansion-factor", "4", "--k", "8",
            "--batch-size", str(B), "--learning-rate", "1e-3", "--epochs", "4",
            "--checkpoint-every", "1", "--cache-dir", str(cache_dir), "--output-dir", str(out),
            "--device", "cpu", *extra]


def _same_params(a: Path, b: Path) -> None:
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_crash_and_resume_is_bit_identical(cache_dir, tmp_path, monkeypatch):
    """A run that dies writing its third epoch's checkpoint, rerun with the
    same command, resumes from the second and ends bit for bit where an
    uninterrupted run ends; ``--no-resume`` starts over."""
    ref = launch.main(_train_cli(cache_dir, tmp_path / "a"))
    orig = launch.SAETrainer.save_checkpoint

    def crashing(self, filename):
        if filename == "checkpoint_epoch3.npz":
            raise RuntimeError("simulated preemption")
        return orig(self, filename)

    monkeypatch.setattr(launch.SAETrainer, "save_checkpoint", crashing)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        launch.main(_train_cli(cache_dir, tmp_path / "b"))
    monkeypatch.setattr(launch.SAETrainer, "save_checkpoint", orig)
    run_b = tmp_path / "b" / "launch_encoder_layer0"
    assert launch._latest_checkpoint(run_b).name == "checkpoint_epoch2.npz"
    assert not (run_b / "sae_final.npz").exists()
    res = launch.main(_train_cli(cache_dir, tmp_path / "b"))
    assert res["resumed_from"] == "checkpoint_epoch2.npz" and ref["resumed_from"] is None
    run_a = Path(ref["run_dir"])
    _same_params(run_a / "sae_final.npz", run_b / "sae_final.npz")
    assert json.loads((run_a / "metrics.json").read_text())[-1] == \
        json.loads((run_b / "metrics.json").read_text())[-1]
    again = launch.main(_train_cli(cache_dir, tmp_path / "b", "--no-resume"))
    assert again["resumed_from"] is None


def test_strip_supervise_args(jlaunch):
    argv = ["train", "--component", "encoder", "--supervise", "--max-restarts", "5",
            "--restart-backoff=2.5", "--layer-idx", "1", "--device", "cpu"]
    want = ["train", "--component", "encoder", "--layer-idx", "1", "--device", "cpu"]
    assert launch._strip_supervise_args(argv) == jlaunch._strip_supervise_args(argv) == want


_PROBE = """
import json, sys
from whisper_sae_tpu_torch.launch import _supervise
import torch
flaky = [sys.executable, "-c", "import pathlib, sys\\n"
         "p = pathlib.Path(sys.argv[1])\\n"
         "if p.exists(): sys.exit(0)\\n"
         "print('boom: device lost'); p.write_text('x'); sys.exit(1)", sys.argv[1] + "/sentinel"]
rc = _supervise(flaky, max_restarts=3, backoff_s=0.0, log_path=__import__("pathlib").Path(
    sys.argv[1]) / "log.json")
rc_fail = _supervise([sys.executable, "-c", "import sys; sys.exit(7)"], max_restarts=2,
                     backoff_s=0.0)
print(json.dumps({"rc": rc, "rc_fail": rc_fail, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_supervisor_restarts_and_leaves_cuda_alone(tmp_path):
    """A child that fails once is rerun and the attempts are logged with the
    failed one's output tail; a child that always fails exits with its code
    after the budget; the supervising process never initialises CUDA."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "rc_fail": 7, "cuda_initialized": False}
    attempts = json.loads((tmp_path / "log.json").read_text())
    assert [a["returncode"] for a in attempts] == [1, 0]
    assert "boom: device lost" in attempts[0]["output_tail"] and "output_tail" not in attempts[1]


def _child_processes(pid: int) -> list[int]:
    """``chip_smoke.py``'s lookup of a process's children in ``/proc``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.child_processes(pid)


def test_supervised_train_survives_sigkill(cache_dir, tmp_path):
    """``launch train --supervise`` through the CLI: the child is killed with
    SIGKILL once its first epoch's checkpoint is on disk (a FIFO at the
    second checkpoint's temporary path holds it there until the kill), the
    supervisor reruns it, the rerun resumes from epoch 1, and the final SAE
    is bit for bit an uninterrupted run's."""
    out = tmp_path / "sup"
    run = out / "launch_encoder_layer0"
    run.mkdir(parents=True)
    fifo = run / "checkpoint_epoch2.npz.tmp"
    os.mkfifo(fifo)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    sup = subprocess.Popen(
        [sys.executable, "-m", "whisper_sae_tpu_torch.launch",
         *_train_cli(cache_dir, out, "--supervise", "--max-restarts", "1",
                     "--restart-backoff", "0")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not (run / "checkpoint_epoch1.npz").exists():
            assert time.time() < deadline and sup.poll() is None, "no first checkpoint"
            time.sleep(0.05)
        children = _child_processes(sup.pid)
        assert len(children) == 1, children
        fifo.unlink()  # the blocked open keeps its inode; the rerun writes a plain file
        os.kill(children[0], signal.SIGKILL)
        text, _ = sup.communicate(timeout=120)
    finally:
        if sup.poll() is None:
            sup.kill()
    assert sup.returncode == 0, text
    attempts = json.loads((out / "launch_supervisor_log.json").read_text())
    assert [a["returncode"] for a in attempts] == [-signal.SIGKILL, 0]
    assert "resuming from" in text and "checkpoint_epoch1.npz (epoch 1," in text
    torch.set_num_threads(1)
    ref = launch.main(_train_cli(cache_dir, tmp_path / "ref"))
    _same_params(Path(ref["run_dir"]) / "sae_final.npz", run / "sae_final.npz")


@pytest.fixture(scope="module")
def trained(cache_dir, tmp_path_factory, jlaunch):
    """Runs of the three families trained by the JAX launcher (f32)."""
    out = tmp_path_factory.mktemp("trained")
    kw = dict(expansion_factor=4, k=8, batch_size=B, epochs=1, warmup_steps=0, use_amp=False,
              cache_dir=cache_dir, output_dir=out)
    jlaunch.train_sae(layer_idx=0, **kw)
    jlaunch.train_transcoder(layer_idx=0, **kw)
    jlaunch.train_crosscoder(layers="0,1", **kw)
    return out


def _copy_runs(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("job_type", ["sae", "transcoder", "crosscoder"])
def test_analyze_matches_jax(cache_dir, trained, tmp_path, jlaunch, job_type):
    """The analyze job of each family over the same cache and checkpoint,
    with every output: the same files, ``summary.json``'s features in the
    same order with their stats at rtol 1e-5, the same co-activation pairs
    and clip names."""
    kw = dict(layer_idx=0, job_type=job_type, layers="0,1", top_k=5, top_n=12,
              batch_samples=4, cache_dir=cache_dir, dashboard=True, clips=3,
              coactivation=8, auto_label=True)
    jout, tout = _copy_runs(trained, tmp_path / "jax"), _copy_runs(trained, tmp_path / "port")
    want = jlaunch.analyze(output_dir=jout, **kw)
    got = launch.analyze(output_dir=tout, device="cpu", **kw)
    jdir, tdir = Path(want["analysis_dir"]), Path(got["analysis_dir"])
    assert sorted(str(p.relative_to(tdir)) for p in tdir.rglob("*")) == \
        sorted(str(p.relative_to(jdir)) for p in jdir.rglob("*"))
    for key in ("num_samples", "num_tokens", "num_features", "clips_written",
                "coactivation_features", "auto_labeled_features", "cross_layer_features"):
        assert got.get(key) == want.get(key), key
    ts, js = (json.loads((d / "summary.json").read_text()) for d in (tdir, jdir))
    assert [f["feature_idx"] for f in ts["top_features"]] == \
        [f["feature_idx"] for f in js["top_features"]]
    assert (ts["samples_processed"], ts["total_activations"]) == \
        (js["samples_processed"], js["total_activations"])
    for g, w in zip(ts["top_features"], js["top_features"]):
        assert g["num_examples"] == w["num_examples"]
        for stat in ("max_activation", "min_activation", "mean_activation"):
            np.testing.assert_allclose(g[stat], w[stat], rtol=1e-5)
    tco, jco = (json.loads((d / "coactivation.json").read_text()) for d in (tdir, jdir))
    assert tco == jco
    feature_file = sorted((tdir / "features").iterdir())[0].name
    tf, jf = (json.loads((d / "features" / feature_file).read_text()) for d in (tdir, jdir))
    assert tf.get("interpretation") == jf.get("interpretation")
    assert [(e["sample_idx"], e["position_idx"]) for e in tf["top_examples"]] == \
        [(e["sample_idx"], e["position_idx"]) for e in jf["top_examples"]]
    if job_type == "crosscoder":
        tx, jx = (json.loads((d / "cross_layer.json").read_text()) for d in (tdir, jdir))
        assert tx == jx


@pytest.fixture(scope="module")
def tiny_runs(cache_dir, tmp_path_factory):
    """SAE runs at whisper-tiny width (D = 384, H = 1536, k = 16) for the
    encoder and the decoder layer 3, written as the JAX launcher writes
    them, and the JAX package's random whisper-tiny weights (seed 5)."""
    out = tmp_path_factory.mktemp("tiny")
    for comp in ("encoder", "decoder"):
        run = out / f"launch_{comp}_layer3"
        run.mkdir()
        p = {k: np.asarray(v) for k, v in jsae.TopKSAE(384, 1536, 16, seed=1).params.items()}
        jsave_pytree(run / "sae_final.npz", p)
        (run / "training_config.json").write_text(json.dumps(
            {"sae": {"expansion_factor": 4, "k": 16}, "component": comp, "layer_idx": 3}))
    params = JW.init_whisper(jax.random.PRNGKey(5), JW.arch_for("openai/whisper-tiny"))
    return out, params


@pytest.mark.parametrize("component", ["encoder", "decoder"])
def test_causal_validate_matches_jax(cache_dir, tiny_runs, tmp_path, monkeypatch, jlaunch,
                                     component):
    out, jparams = tiny_runs
    tparams = TW.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    monkeypatch.setattr(launch, "init_whisper", lambda gen, arch: tparams)
    jout, tout = _copy_runs(out, tmp_path / "jax"), _copy_runs(out, tmp_path / "port")
    kw = dict(component=component, layer_idx=3, num_samples=2, sweep_features=3,
              cache_dir=cache_dir)
    want = jlaunch.causal_validate(output_dir=jout, random_whisper=True, seed=5, **kw)
    got = launch.causal_validate(output_dir=tout, random_whisper=True, seed=5, device="cpu",
                                 **kw)
    for key in ("component", "layer_idx", "num_samples", "token_agreement"):
        assert got[key] == want[key], key
    assert abs(got["logit_kl"] - want["logit_kl"]) <= 1e-4 * abs(want["logit_kl"])
    assert [r["feature_idx"] for r in got["ablation_sweep"]] == \
        [r["feature_idx"] for r in want["ablation_sweep"]]
    for g, w in zip(got["ablation_sweep"], want["ablation_sweep"]):
        assert abs(g["logit_kl"] - w["logit_kl"]) <= 1e-4 * abs(w["logit_kl"])
    saved = json.loads((tout / f"launch_{component}_layer3" / "analysis"
                        / "causal_validation.json").read_text())
    assert saved == got


def test_cli_profile_writes_a_trace(cache_dir, tmp_path):
    """``train.py --profile DIR`` wraps training in ``utils.profiling.trace``:
    a Chrome trace of the run lands in DIR."""
    import yaml

    cfg = yaml.safe_load((REPO / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"].update(expansion_factor=4, k=8)
    cfg["training"].update(batch_size=B, epochs=1, warmup_steps=0)
    cfg["data"]["cache_dir"] = str(cache_dir)
    cfg["output_dir"] = str(tmp_path / "out")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    (trainer,) = cli.main(["--config", str(path), "--layer", "encoder:0", "--no-wandb",
                           "--device", "cpu", "--profile", str(tmp_path / "prof")]).values()
    assert trainer.global_step == -(-ROWS // B)
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
