"""Job launcher of the port (counterpart of ``launcher/launch.py``): the
extraction job, SAE training (one layer or ``--all-layers``), the
transcoder and crosscoder training jobs, feature analysis, causal
validation and batch transcription, with the JAX launcher's flags,
defaults, run directories and output files::

    python -m whisper_sae_tpu_torch.launch extract --capture-mlp --random-whisper \\
        --dataset synthetic --max-samples 64 --layers-encoder 0,1,2,3 --layers-decoder ""
    python -m whisper_sae_tpu_torch.launch train --all-layers --supervise
    python -m whisper_sae_tpu_torch.launch train-transcoder --component encoder --layer-idx 0
    python -m whisper_sae_tpu_torch.launch train-crosscoder --layers 0,1,2,3 [--relu]
    python -m whisper_sae_tpu_torch.launch analyze --layer-idx 0 --dashboard --clips 4
    python -m whisper_sae_tpu_torch.launch causal-validate --layer-idx 0 --random-whisper
    python -m whisper_sae_tpu_torch.launch transcribe clips/ --random-whisper --output t.json

Every job runs on the card unless ``--device cpu`` is given (then the
kernels' plain versions run).  ``--dataset synthetic`` draws seeded
synthetic speech; any other dataset reads LibriSpeech's mel cache under
``--cache-dir`` (ingesting the HF stream first when there is none).
Training jobs resume from the newest ``checkpoint_epoch*.npz`` of their
run directory unless ``--no-resume``; with ``--supervise`` a parent that
never touches the card reruns the job in a child process after a crash,
up to ``--max-restarts`` times.  The transcoder and crosscoder jobs load
their caches whole up to ``--max-resident-gb``; above it they stream from
the shards, as the JAX launcher's do (``launcher/launch.py:420-485``,
``:572-627``): the transcoder as chunked epochs through a paired reader,
the crosscoder batch by batch through a multi-layer loader.

Under ``torchrun`` (one process per GPU) the extraction job shards each
capture batch over a data mesh of every rank when there is more than
one, and the training jobs take a data mesh of every rank; rank 0 alone
writes the files::

    torchrun --standalone --nproc_per_node=2 -m whisper_sae_tpu_torch.launch train-transcoder
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import deque
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .analysis import (
    AudioClipExtractor, FeatureReport, TopKTracker, auto_label_features, compute_coactivation,
    create_librispeech_audio_loader, create_synthetic_audio_loader, generate_dashboard,
    save_coactivation,
)
from .causal import feature_ablation_sweep, substitution_effect
from .config import DataConfig, SAEConfig, TrainingConfig, WhisperConfig
from .data.feature_cache import FeatureCache, extract_and_cache_features
from .data.librispeech import (
    AudioBatchLoader,
    LibriSpeechDataset,
    LibriSpeechFeaturesOnly,
    SyntheticSpeechDataset,
)
from .data.loader import ActivationLoader, MultiLayerLoader, PairedActivationLoader
from .models.crosscoder import create_crosscoder, load_trained_crosscoder
from .models.sae import create_sae, load_trained_sae
from .models.transcoder import create_transcoder, load_trained_transcoder
from .data.mel import SAMPLE_RATE, log_mel_spectrogram
from .models.whisper import (
    _hf_snapshot, arch_for, greedy_decode_cached, init_whisper, load_pretrained, params_to,
)
from .parallel.mesh import make_mesh
from .parallel.multihost import initialize_if_needed, is_primary, launched
from .training.coder_trainers import CrosscoderTrainer, TranscoderTrainer
from .training.trainer import SAETrainer
from .utils.checkpoint import save_pytree
from .utils.device import resolve_device
from .utils.wavio import read_wav, resample

CACHE_DIR = Path("cache")
OUTPUT_DIR = Path("outputs")


def _job_mesh(dev: torch.device, min_ranks: int = 1):
    """Under torchrun: the process group (gloo for ``--device cpu``) and a
    pure-data mesh of every rank, if there are at least ``min_ranks``;
    else ``None`` (one process, the single-device path)."""
    if not launched():
        return None
    initialize_if_needed(backend="gloo" if dev.type == "cpu" else None)
    import torch.distributed as dist

    n = dist.get_world_size()
    if n < min_ranks:
        return None
    mesh = make_mesh(data=n, model=1)
    if is_primary():
        print(f"mesh: data={mesh.shape['data']}", file=sys.stderr)
    return mesh


def _parse_layers(spec: str) -> list[int]:
    return [int(x) for x in spec.split(",") if x != ""]


def _latest_checkpoint(run_dir: Path) -> Path | None:
    ckpts = []
    for p in run_dir.glob("checkpoint_epoch*.npz"):
        m = re.search(r"epoch(\d+)", p.name)
        if m:
            ckpts.append((int(m.group(1)), p))
    return max(ckpts)[1] if ckpts else None


_SUPERVISE_FLAGS = ("--supervise", "--max-restarts", "--restart-backoff")


def _strip_supervise_args(argv: list[str]) -> list[str]:
    """The argv without the supervisor's own flags: the child runs the
    plain (auto-resuming) job."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--supervise":
            continue
        if a in ("--max-restarts", "--restart-backoff"):
            skip = True
            continue
        if a.split("=", 1)[0] in _SUPERVISE_FLAGS:
            continue
        out.append(a)
    return out


def _supervise(child_argv: list[str], max_restarts: int = 3, backoff_s: float = 10.0,
               log_path: Path | None = None) -> int:
    """Run ``child_argv`` as a subprocess and rerun it after a nonzero
    exit, up to ``max_restarts`` times with linear backoff.  Training jobs
    resume from their newest checkpoint, extraction from its last
    progress cut, so a rerun continues the run.  Each attempt (its exit
    code, time and, when it failed, the tail of its output) goes into
    ``log_path`` as it ends.

    The supervisor makes no CUDA call: the card is held by the child
    alone, freed when it exits, taken again by the rerun.  Returns the
    last exit code (0 on success)."""
    # the child finds this package whichever way the parent imported it
    src = str(Path(__file__).resolve().parent.parent)
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONUNBUFFERED": "1",
           "PYTHONPATH": src + (os.pathsep + path if path else "")}
    attempts = []
    rc = 0
    for attempt in range(max_restarts + 1):
        if attempt:
            print(f"supervisor: restart {attempt}/{max_restarts} after exit {rc} "
                  f"(backoff {backoff_s * attempt:.0f}s)", file=sys.stderr)
            time.sleep(backoff_s * attempt)
        t0 = time.time()
        # echo the child's merged output live and keep its tail, so a failed
        # attempt's error text survives into the log
        tail: deque[str] = deque(maxlen=40)
        proc = subprocess.Popen(child_argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, errors="replace", env=env)
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            tail.append(line.rstrip("\n"))
        rc = proc.wait()
        entry = {"attempt": attempt, "returncode": rc, "elapsed_s": round(time.time() - t0, 1),
                 "finished_at": datetime.now().isoformat()}
        if rc != 0:
            entry["output_tail"] = list(tail)
        attempts.append(entry)
        if log_path is not None:
            log_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = log_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(attempts, indent=2))
            tmp.rename(log_path)
        if rc == 0:
            break
    return rc


def extract_features(
    model_name: str = "openai/whisper-tiny",
    layers_encoder: str = "0,1,2,3",
    layers_decoder: str = "0,1,2,3",
    max_samples: int = 1000,
    batch_size: int = 64,
    dataset: str = "librispeech_asr",
    cache_dir: str | Path = CACHE_DIR,
    random_whisper: bool = False,
    seed: int = 42,
    capture_mlp: bool = False,
    checkpoint_every: int | None = 2048,
    auto_resume: bool = True,
    cache_dtype: str | None = None,
    device=None,
) -> dict:
    """Extraction job: per-layer caches (and, with ``capture_mlp``, the
    per-layer (mlp_in, mlp_out) pairs), ``extraction_log.json``,
    ``metadata.json`` and ``transcripts.json`` under ``cache_dir/features``."""
    dev = resolve_device(device)
    t0 = time.time()
    enc_layers = _parse_layers(layers_encoder)
    dec_layers = _parse_layers(layers_decoder)
    whisper_cfg = WhisperConfig(model_name=model_name)
    data_cfg = DataConfig(dataset_name=dataset, max_samples=max_samples, cache_dir=Path(cache_dir))
    arch = arch_for(model_name)
    gen = torch.Generator(device=dev).manual_seed(seed)  # weights made where they run
    if random_whisper:
        params = init_whisper(gen, arch)
    else:
        try:
            params, arch = load_pretrained(model_name)
        except Exception:  # offline without a local snapshot
            print("pretrained load failed; using random weights", file=sys.stderr)
            params = init_whisper(gen, arch)
    if dataset == "synthetic":
        ds = SyntheticSpeechDataset(num_samples=max_samples, seed=seed, n_mels=arch.n_mels,
                                    device=dev)
    else:
        ds = LibriSpeechDataset(data_cfg, n_mels=arch.n_mels, device=dev)
    features_only = LibriSpeechFeaturesOnly(ds, record_texts=True)
    cache = FeatureCache(Path(cache_dir) / "features", whisper_cfg, data_cfg)
    # several ranks: each batch's capture sharded over a data mesh
    # (launcher/launch.py:105-121 of the JAX package)
    mesh = _job_mesh(dev, min_ranks=2)
    extract_and_cache_features(
        params, arch, AudioBatchLoader(features_only, batch_size=batch_size), cache,
        encoder_layers=enc_layers, decoder_layers=dec_layers, max_samples=max_samples,
        compute_dtype=torch.bfloat16, capture_mlp=capture_mlp,
        checkpoint_every=checkpoint_every, resume=auto_resume, cache_dtype=cache_dtype,
        device=dev, mesh=mesh,
    )
    features = Path(cache_dir) / "features"
    tpath = features / "transcripts.json"
    if features_only.texts:
        transcripts: dict[str, str] = {}
        if tpath.exists():
            try:
                transcripts = json.loads(tpath.read_text())
            except json.JSONDecodeError:
                pass
        transcripts.update({str(i): t for i, t in features_only.texts.items()})
        tpath.write_text(json.dumps(transcripts, indent=2))
    log = {
        "model_name": model_name,
        "encoder_layers": enc_layers,
        "decoder_layers": dec_layers,
        "max_samples": max_samples,
        "dataset": dataset,
        "seed": seed,
        "capture_mlp": capture_mlp,
        "elapsed_s": round(time.time() - t0, 1),
        "finished_at": datetime.now().isoformat(),
        "backend": dev.type,
    }
    if not is_primary():
        return log
    (features / "extraction_log.json").write_text(json.dumps(log, indent=2))
    (features / "metadata.json").write_text(json.dumps({
        "model_name": model_name,
        "layers": {"encoder": enc_layers, "decoder": dec_layers},
        "created_at": datetime.now().isoformat(),
    }, indent=2))
    return log


def _stored_bytes(meta) -> int:
    """A cached layer's bytes as stored (the resident budget counts these)."""
    return meta.num_tokens * meta.hidden_dim * (2 if meta.dtype == "bfloat16" else 4)


class _PairReader:
    """(mlp_in, mlp_out) rows gathered together from two lazy sources; row
    bytes count both, in f32 (the JAX launcher's budget)."""

    def __init__(self, x, y, hidden_dim: int):
        self.x, self.y = x, y
        self.num_rows = int(x.shape[0])
        self.row_bytes = 2 * hidden_dim * 4

    def gather(self, idx):
        return self.x[idx], self.y[idx]


def _run(trainer, loader, epochs: int, checkpoint_every: int | None, run_dir: Path,
         auto_resume: bool) -> str | None:
    resumed_from = None
    if auto_resume:
        ckpt = _latest_checkpoint(run_dir)
        if ckpt is not None:
            trainer.load_checkpoint(ckpt)
            resumed_from = ckpt.name
            if trainer.is_primary:
                print(f"resuming from {ckpt} (epoch {trainer.epoch}, step {trainer.global_step})",
                      file=sys.stderr)
    trainer.train(loader, epochs=epochs, checkpoint_every=checkpoint_every)
    return resumed_from


def _save_params(trainer, path: Path) -> None:
    """The trained parameters, whole, written by the primary rank."""
    params = trainer.full_params()
    if trainer.is_primary:
        save_pytree(path, params)


def train_sae(
    component: str = "encoder",
    layer_idx: int = 0,
    model_name: str = "openai/whisper-tiny",
    expansion_factor: int = 8,
    k: int = 32,
    batch_size: int = 4096,
    learning_rate: float = 1e-4,
    epochs: int = 10,
    warmup_steps: int = 1000,
    use_amp: bool = True,
    matmul_precision: str = "default",
    cache_dir: str | Path = CACHE_DIR,
    output_dir: str | Path = OUTPUT_DIR,
    experiment_name: str = "launch",
    seed: int = 42,
    checkpoint_every: int | None = None,
    auto_resume: bool = True,
    device=None,
) -> dict:
    """Per-layer SAE training on a cached layer: ``sae_final.npz`` (and
    ``.pt``), ``metrics.json``, ``training_config.json`` (the SAE config
    ``load_trained_sae`` reads) and ``checkpoint_epoch*.npz`` every
    ``checkpoint_every`` epochs.  A multi-shard cache streams from disk
    and resamples from a sorted subsample of 8 resample batches."""
    dev = resolve_device(device)
    t0 = time.time()
    whisper_cfg = WhisperConfig(model_name=model_name)
    cache = FeatureCache(Path(cache_dir) / "features", whisper_cfg, DataConfig())
    if not cache.has_cache(component, layer_idx):
        raise FileNotFoundError(
            f"no cached features for {component} layer {layer_idx}; run extract first")
    sae_cfg = SAEConfig(expansion_factor=expansion_factor, k=k)
    train_cfg = TrainingConfig(batch_size=batch_size, learning_rate=learning_rate, epochs=epochs,
                              warmup_steps=warmup_steps, use_amp=use_amp, seed=seed,
                              matmul_precision=matmul_precision)
    meta = cache.load_metadata(component, layer_idx)
    sae = create_sae(sae_cfg, input_dim=meta.hidden_dim, seed=seed, device=dev)
    run_dir = Path(output_dir) / f"{experiment_name}_{component}_layer{layer_idx}"
    run_dir.mkdir(parents=True, exist_ok=True)
    trainer = SAETrainer(sae, train_cfg, run_dir=run_dir, mesh=_job_mesh(dev))
    loader = cache.get_dataloader(component, layer_idx, batch_size=batch_size, seed=seed)
    if hasattr(loader, "reader"):  # out of core: a bounded resample subsample
        idx = np.random.default_rng(seed).permutation(meta.num_tokens)[
            :8 * trainer.resample_batch_size]
        trainer.set_resample_dataset(loader.reader.gather(np.sort(idx)))
    else:
        trainer.set_resample_dataset(loader.data)
    resumed_from = _run(trainer, loader, epochs, checkpoint_every, run_dir, auto_resume)
    trainer.save_final()
    trainer.save_metrics()
    result = {
        "component": component,
        "layer_idx": layer_idx,
        "num_tokens": meta.num_tokens,
        "final_loss": trainer.metrics_history[-1].loss if trainer.metrics_history else None,
        "elapsed_s": round(time.time() - t0, 1),
        "run_dir": str(run_dir),
        "resumed_from": resumed_from,
    }
    if not trainer.is_primary:
        return result
    (run_dir / "training_config.json").write_text(json.dumps({
        "sae": json.loads(sae_cfg.model_dump_json()),
        "training": json.loads(train_cfg.model_dump_json()),
        "whisper": json.loads(whisper_cfg.model_dump_json()),
        "component": component,
        "layer_idx": layer_idx,
        "finished_at": datetime.now().isoformat(),
    }, indent=2))
    return result


def train_all_layers(
    model_name: str = "openai/whisper-tiny",
    layers_encoder: str = "0,1,2,3",
    layers_decoder: str = "0,1,2,3",
    **kwargs,
) -> list[dict]:
    """Every listed layer in turn, encoder then decoder."""
    results = []
    for layer in _parse_layers(layers_encoder):
        results.append(train_sae(component="encoder", layer_idx=layer, model_name=model_name,
                                 **kwargs))
    for layer in _parse_layers(layers_decoder):
        results.append(train_sae(component="decoder", layer_idx=layer, model_name=model_name,
                                 **kwargs))
    return results


def train_transcoder(
    component: str = "encoder",
    layer_idx: int = 0,
    model_name: str = "openai/whisper-tiny",
    expansion_factor: int = 8,
    k: int = 32,
    use_skip: bool = True,
    batch_size: int = 4096,
    learning_rate: float = 1e-4,
    epochs: int = 10,
    warmup_steps: int = 1000,
    use_amp: bool = True,
    matmul_precision: str = "default",
    cache_dir: str | Path = CACHE_DIR,
    output_dir: str | Path = OUTPUT_DIR,
    experiment_name: str = "launch",
    seed: int = 42,
    checkpoint_every: int | None = None,
    auto_resume: bool = True,
    max_resident_bytes: int = 8 << 30,
    device=None,
) -> dict:
    """Transcoder training on cached (mlp_in, mlp_out) pairs (extract with
    ``--capture-mlp`` first).  The Skip variant starts from zero decoder
    and skip with ``set_output_bias(mean(mlp_out))``."""
    dev = resolve_device(device)
    t0 = time.time()
    whisper_cfg = WhisperConfig(model_name=model_name)
    cache = FeatureCache(Path(cache_dir) / "features", whisper_cfg, DataConfig())
    for kind in ("mlp_in", "mlp_out"):
        if not cache.has_cache(f"{component}_{kind}", layer_idx):
            raise FileNotFoundError(f"no cached {component}_{kind} for layer {layer_idx}; "
                                    "run extract with --capture-mlp first")
    kinds = (f"{component}_mlp_in", f"{component}_mlp_out")
    stored = sum(_stored_bytes(cache.load_metadata(c, layer_idx)) for c in kinds)
    resident = stored <= max_resident_bytes
    load = cache.load if resident else cache.load_rows
    (x, meta), (y, _) = (load(c, layer_idx) for c in kinds)
    train_cfg = TrainingConfig(batch_size=batch_size, learning_rate=learning_rate, epochs=epochs,
                              warmup_steps=warmup_steps, use_amp=use_amp, seed=seed,
                              matmul_precision=matmul_precision)
    hidden_dim = expansion_factor * meta.hidden_dim
    model = create_transcoder(meta.hidden_dim, meta.hidden_dim, hidden_dim, k=k,
                              use_skip=use_skip, seed=seed, device=dev)
    if use_skip:
        # a multi-shard cache's mean in chunks; a single shard's at once
        model.set_output_bias(y.mean0() if hasattr(y, "mean0") else y.float().mean(dim=0))
    run_dir = Path(output_dir) / f"{experiment_name}_{component}_transcoder_layer{layer_idx}"
    run_dir.mkdir(parents=True, exist_ok=True)
    trainer = TranscoderTrainer(model, train_cfg, run_dir=run_dir, mesh=_job_mesh(dev))
    loader = PairedActivationLoader(x, y, batch_size=batch_size, seed=seed)
    if resident:
        trainer.set_resample_dataset(loader.data)
    else:
        # out of core: chunked epochs gathered from the lazy sources, half
        # the SAE's chunk (x and y are staged); resampling from a sorted
        # subsample of 8 resample batches
        loader.reader = _PairReader(x, y, meta.hidden_dim)
        loader.chunk_tokens = max(batch_size, (3 << 30) // loader.reader.row_bytes)
        idx = np.sort(np.random.default_rng(seed).permutation(x.shape[0])[
            :8 * trainer.resample_batch_size])
        trainer.set_resample_dataset((x[idx], y[idx]))
    resumed_from = _run(trainer, loader, epochs, checkpoint_every, run_dir, auto_resume)
    _save_params(trainer, run_dir / "transcoder_final.npz")
    trainer.save_metrics()
    result = {
        "component": component,
        "layer_idx": layer_idx,
        "num_tokens": int(x.shape[0]),
        "final_loss": trainer.metrics_history[-1].loss if trainer.metrics_history else None,
        "elapsed_s": round(time.time() - t0, 1),
        "run_dir": str(run_dir),
        "resumed_from": resumed_from,
    }
    if not trainer.is_primary:
        return result
    (run_dir / "training_config.json").write_text(json.dumps({
        "transcoder": {"input_dim": meta.hidden_dim, "output_dim": meta.hidden_dim,
                       "hidden_dim": hidden_dim, "k": k, "use_skip": use_skip},
        "training": json.loads(train_cfg.model_dump_json()),
        "whisper": json.loads(whisper_cfg.model_dump_json()),
        "component": component,
        "layer_idx": layer_idx,
        "finished_at": datetime.now().isoformat(),
    }, indent=2))
    return result


def train_crosscoder(
    component: str = "encoder",
    layers: str = "0,1,2,3",
    model_name: str = "openai/whisper-tiny",
    expansion_factor: int = 8,
    k: int | None = 32,
    use_topk: bool = True,
    batch_size: int = 4096,
    learning_rate: float = 1e-4,
    epochs: int = 10,
    warmup_steps: int = 1000,
    use_amp: bool = True,
    matmul_precision: str = "default",
    cache_dir: str | Path = CACHE_DIR,
    output_dir: str | Path = OUTPUT_DIR,
    experiment_name: str = "launch",
    seed: int = 42,
    checkpoint_every: int | None = None,
    auto_resume: bool = True,
    max_resident_bytes: int = 8 << 30,
    device=None,
) -> dict:
    """Crosscoder training on the row-aligned caches of several layers,
    stacked to ``[N, L, D]`` (TopK by default, ``use_topk=False`` for the
    ReLU + decoder-norm-weighted L1 variant)."""
    dev = resolve_device(device)
    t0 = time.time()
    layer_list = _parse_layers(layers)
    whisper_cfg = WhisperConfig(model_name=model_name)
    cache = FeatureCache(Path(cache_dir) / "features", whisper_cfg, DataConfig())
    for layer in layer_list:
        if not cache.has_cache(component, layer):
            raise FileNotFoundError(
                f"no cached features for {component} layer {layer}; run extract first")
    metas = [cache.load_metadata(component, layer) for layer in layer_list]
    meta = metas[-1]
    train_cfg = TrainingConfig(batch_size=batch_size, learning_rate=learning_rate, epochs=epochs,
                              warmup_steps=warmup_steps, use_amp=use_amp, seed=seed,
                              matmul_precision=matmul_precision)
    d_sae = expansion_factor * meta.hidden_dim
    model = create_crosscoder(meta.hidden_dim, len(layer_list), d_sae, k=k, use_topk=use_topk,
                              layer_indices=layer_list, seed=seed, device=dev)
    run_dir = Path(output_dir) / (
        f"{experiment_name}_{component}_crosscoder_l{'-'.join(map(str, layer_list))}")
    run_dir.mkdir(parents=True, exist_ok=True)
    trainer = CrosscoderTrainer(model, train_cfg, run_dir=run_dir, mesh=_job_mesh(dev))
    if sum(_stored_bytes(m) for m in metas) <= max_resident_bytes:
        stacked = torch.stack([cache.load(component, layer)[0] for layer in layer_list], dim=1)
        loader = ActivationLoader(stacked, batch_size=batch_size, seed=seed)
    else:
        # out of core: batch by batch through the multi-layer loader.  The
        # JAX launcher also hangs a stacked reader on it, which its
        # ``train()`` never reads (the loader has no ``.data``)
        feats = [cache.load_rows(component, layer)[0] for layer in layer_list]
        loader = MultiLayerLoader(feats, batch_size=batch_size, seed=seed)
    resumed_from = _run(trainer, loader, epochs, checkpoint_every, run_dir, auto_resume)
    _save_params(trainer, run_dir / "crosscoder_final.npz")
    trainer.save_metrics()
    result = {
        "component": component,
        "layers": layer_list,
        "num_tokens": metas[0].num_tokens,
        "final_loss": trainer.metrics_history[-1].loss if trainer.metrics_history else None,
        "elapsed_s": round(time.time() - t0, 1),
        "run_dir": str(run_dir),
        "resumed_from": resumed_from,
    }
    if not trainer.is_primary:
        return result
    (run_dir / "training_config.json").write_text(json.dumps({
        "crosscoder": {"d_model": meta.hidden_dim, "n_layers": len(layer_list), "d_sae": d_sae,
                       "k": k, "use_topk": use_topk, "layer_indices": layer_list},
        "training": json.loads(train_cfg.model_dump_json()),
        "whisper": json.loads(whisper_cfg.model_dump_json()),
        "component": component,
        "finished_at": datetime.now().isoformat(),
    }, indent=2))
    return result


def _read_json(path: Path) -> dict:
    """A JSON sidecar, or {} when it is missing or unreadable."""
    if path.exists():
        try:
            return json.loads(path.read_text())
        except json.JSONDecodeError:
            pass
    return {}


def analyze(
    component: str = "encoder",
    layer_idx: int = 0,
    model_name: str = "openai/whisper-tiny",
    run_dir: str | Path | None = None,
    top_k: int = 20,
    top_n: int = 100,
    batch_samples: int = 8,
    cache_dir: str | Path = CACHE_DIR,
    output_dir: str | Path = OUTPUT_DIR,
    experiment_name: str = "launch",
    dashboard: bool = False,
    job_type: str = "sae",
    layers: str = "0,1,2,3",
    clips: int = 0,
    clips_per_feature: int = 3,
    coactivation: int = 0,
    auto_label: bool = False,
    device=None,
) -> dict:
    """Feature analysis of a trained coder over its activation cache:
    ``batch_samples`` clips at a time through the coder's ``encode`` on
    the device (kernel C behind a TopK coder's f32 encode product on the
    card), merged into the ``[F, k]`` tracker; writes ``summary.json``,
    ``features/*.json``, ``tracker_state.json`` and ``analysis_log.json``
    into ``<run_dir>/analysis``, with ``cross_layer.json`` for a
    crosscoder, ``coactivation.json``, ``audio/`` and ``dashboard.html``
    when asked.  Transcriptions recorded at extraction
    (``transcripts.json``) join the tracked examples.

    ``job_type``: "sae" (the layer cache), "transcoder" (the layer's
    mlp_in cache through the trained encoder) or "crosscoder" (the
    ``layers`` caches stacked to ``[B, L, D]``, in the trained order)."""
    if job_type not in ("sae", "transcoder", "crosscoder"):
        raise ValueError(f"unsupported job_type {job_type!r}")
    dev = resolve_device(device)
    t0 = time.time()
    cache = FeatureCache(Path(cache_dir) / "features", WhisperConfig(model_name=model_name),
                         DataConfig())
    # transcoder features are functions of the MLP input (fc1's operand)
    cache_component = f"{component}_mlp_in" if job_type == "transcoder" else component
    layer_list = _parse_layers(layers) if job_type == "crosscoder" else [layer_idx]
    for layer in layer_list:
        if not cache.has_cache(cache_component, layer):
            raise FileNotFoundError(
                f"no cached features for {cache_component} layer {layer}; run extract first"
                + (" (with --capture-mlp)" if job_type == "transcoder" else ""))
    if run_dir is None:
        if job_type == "crosscoder":
            name = f"{experiment_name}_{component}_crosscoder_l{'-'.join(map(str, layer_list))}"
        else:
            kind = "" if job_type == "sae" else "_transcoder"
            name = f"{experiment_name}_{component}{kind}_layer{layer_idx}"
        run_dir = Path(output_dir) / name
    run_dir = Path(run_dir)
    if job_type == "sae":
        sae = load_trained_sae(run_dir, device=dev)
        num_features = sae.hidden_dim
    elif job_type == "transcoder":
        sae = load_trained_transcoder(run_dir, device=dev)
        num_features = sae.hidden_dim
    else:
        sae = load_trained_crosscoder(run_dir, device=dev)
        num_features = sae.d_sae
        if layer_list != list(sae.layer_indices):
            raise ValueError(
                f"--layers {layer_list} does not match the trained crosscoder's layer order "
                f"{list(sae.layer_indices)} (training_config.json); a reordered stack would "
                "encode layers with the wrong weights")

    rows_list = [cache.load_rows(cache_component, layer)[0] for layer in layer_list]
    meta = cache.load_metadata(cache_component, layer_list[0])
    frames = max(meta.num_tokens // max(meta.num_samples, 1), 1)

    @torch.no_grad()
    def encode_chunk(lo: int, hi: int) -> torch.Tensor:
        rows = [r[lo * frames: hi * frames].float() for r in rows_list]
        chunk = torch.stack(rows, dim=1) if job_type == "crosscoder" else rows[0]
        return sae.encode(chunk)  # [b*frames, F] on the device

    transcripts = _read_json(Path(cache_dir) / "features" / "transcripts.json")
    tracker = TopKTracker(num_features=num_features, k=top_k, device=dev)
    for lo in range(0, meta.num_samples, batch_samples):
        hi = min(lo + batch_samples, meta.num_samples)
        tracker.update(
            encode_chunk(lo, hi).reshape(hi - lo, frames, num_features),
            sample_indices=np.arange(lo, hi),
            transcriptions=[transcripts.get(str(i)) for i in range(lo, hi)]
            if transcripts else None,
        )

    analysis_dir = run_dir / "analysis"
    report = FeatureReport(tracker, analysis_dir)
    labeled = 0
    if auto_label and transcripts:
        # only the reported features: a pass over all F is minutes at
        # whisper-large widths
        tops = report.generate_summary_report(top_n=top_n)["top_features"]
        labeled = len(auto_label_features(
            tracker, report, feature_indices=[f["feature_idx"] for f in tops]))
    report.save_reports(top_n=top_n)

    summary = json.loads((analysis_dir / "summary.json").read_text())
    cross_layer_count = None
    if job_type == "crosscoder":
        # decoder-norm layer profiles: which layers each latent writes to
        norms = sae.get_feature_layer_norms().detach().cpu().numpy()  # [S, L]
        cross = sae.get_cross_layer_features().cpu().numpy()
        cross_layer_count = int(cross.sum())
        (analysis_dir / "cross_layer.json").write_text(json.dumps({
            "layer_indices": list(map(int, sae.layer_indices)),
            "num_cross_layer_features": cross_layer_count,
            "cross_layer_fraction": round(float(cross.mean()), 5),
            "top_feature_layer_profiles": {
                str(f["feature_idx"]): [round(float(x), 5) for x in norms[f["feature_idx"]]]
                for f in summary["top_features"]
            },
        }, indent=2))
    if coactivation:
        # a second streaming pass: [M, M] co-occurrence of the report's top features
        co_feats = [f["feature_idx"] for f in summary["top_features"][:coactivation]]
        co = compute_coactivation(encode_chunk, meta.num_samples, batch_samples, co_feats)
        save_coactivation(co, analysis_dir / "coactivation.json")
    clip_count = 0
    if clips:
        # clips of the top features into <analysis>/audio, where the
        # dashboard links them; the audio is the dataset recorded at
        # extraction (extraction_log.json): synthetic rebuilds from the seed
        elog = _read_json(Path(cache_dir) / "features" / "extraction_log.json")
        if elog.get("dataset") == "synthetic":
            ds = SyntheticSpeechDataset(num_samples=elog.get("max_samples", meta.num_samples),
                                        seed=elog.get("seed", 42))
            audio_loader = create_synthetic_audio_loader(ds)
        else:
            audio_loader = create_librispeech_audio_loader()
        extractor = AudioClipExtractor(tracker, audio_loader, analysis_dir / "audio")
        written = extractor.extract_all_clips(
            feature_indices=[f["feature_idx"] for f in summary["top_features"][:clips]],
            max_clips_per_feature=clips_per_feature)
        extractor.save_manifest()
        clip_count = sum(len(v) for v in written.values())

    result = {
        "component": component,
        "layer_idx": layer_idx,
        "job_type": job_type,
        "num_samples": meta.num_samples,
        "num_tokens": meta.num_tokens,
        "num_features": num_features,
        "top_feature": summary["top_features"][0] if summary["top_features"] else None,
        "elapsed_s": round(time.time() - t0, 1),
        "analysis_dir": str(analysis_dir),
    }
    if clips:
        result["clips_written"] = clip_count
    if cross_layer_count is not None:
        result["cross_layer_features"] = cross_layer_count
    if coactivation:
        result["coactivation_features"] = min(coactivation, len(summary["top_features"]))
    if auto_label:
        result["auto_labeled_features"] = labeled
    if dashboard:
        result["dashboard"] = str(generate_dashboard(analysis_dir))
    (analysis_dir / "analysis_log.json").write_text(json.dumps(result, indent=2))
    return result


def causal_validate(
    component: str = "encoder",
    layer_idx: int = 0,
    model_name: str = "openai/whisper-tiny",
    run_dir: str | Path | None = None,
    num_samples: int = 4,
    sweep_features: int = 0,
    random_whisper: bool = False,
    seed: int = 42,
    cache_dir: str | Path = CACHE_DIR,
    output_dir: str | Path = OUTPUT_DIR,
    experiment_name: str = "launch",
    device=None,
) -> dict:
    """Causal validation of a trained SAE: the substitution effect (logit
    KL and greedy-token agreement with the layer replaced by its SAE
    reconstruction) and, with ``sweep_features``, a per-feature ablation
    sweep ranked by marginal logit KL (the report's top features when
    ``summary.json`` is there, else 0..N-1).  The audio replays the
    dataset recorded at extraction (``extraction_log.json``; synthetic
    rebuilds from the logged seed, any other dataset reads LibriSpeech's
    mel cache of ``num_samples`` under the default ``cache/``).  The Whisper weights are made as the
    extraction job makes them.  Writes ``causal_validation.json`` into
    ``<run_dir>/analysis``."""
    if component not in ("encoder", "decoder"):
        raise ValueError("causal patching intervenes on encoder or decoder layers")
    dev = resolve_device(device)
    t0 = time.time()
    if run_dir is None:
        run_dir = Path(output_dir) / f"{experiment_name}_{component}_layer{layer_idx}"
    run_dir = Path(run_dir)
    sae = load_trained_sae(run_dir, device=dev)

    arch = arch_for(model_name)
    if random_whisper:
        params = init_whisper(torch.Generator(device=dev).manual_seed(seed), arch)
    else:
        try:
            params, arch = load_pretrained(model_name)
            params = params_to(params, dev)
        except Exception:  # offline without a local snapshot
            print("pretrained load failed; using random weights", file=sys.stderr)
            params = init_whisper(torch.Generator(device=dev).manual_seed(seed), arch)

    elog = _read_json(Path(cache_dir) / "features" / "extraction_log.json")
    if elog.get("dataset", "synthetic") == "synthetic":
        ds = SyntheticSpeechDataset(num_samples=max(num_samples, 1), seed=elog.get("seed", seed),
                                    n_mels=arch.n_mels, device=dev)
    else:
        # as the JAX job: the default cache_dir and a stem keyed by
        # num_samples (launcher/launch.py:1122-1126)
        ds = LibriSpeechDataset(DataConfig(dataset_name=elog["dataset"], max_samples=num_samples),
                                n_mels=arch.n_mels, device=dev)
    mels = torch.from_numpy(np.stack([ds[i]["input_features"] for i in range(num_samples)]))
    mels = mels.to(dev)

    result = {
        "component": component,
        "layer_idx": layer_idx,
        "num_samples": num_samples,
        **substitution_effect(params, mels, arch, sae, layer_idx, component=component),
    }
    if sweep_features:
        feats = list(range(sweep_features))
        spath = run_dir / "analysis" / "summary.json"
        if spath.exists():
            tops = json.loads(spath.read_text())["top_features"]
            feats = [f["feature_idx"] for f in tops[:sweep_features]]
        result["ablation_sweep"] = feature_ablation_sweep(params, mels, arch, sae, layer_idx,
                                                          feats, component=component)
    result["elapsed_s"] = round(time.time() - t0, 1)
    out_dir = run_dir / "analysis"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "causal_validation.json").write_text(json.dumps(result, indent=2))
    return result


def transcribe_job(
    inputs: list[str] | None = None,
    model_name: str = "openai/whisper-tiny",
    random_whisper: bool = False,
    max_len: int = 224,
    batch_size: int = 16,
    output: str | Path | None = None,
    num_synthetic: int = 0,
    device=None,
) -> dict:
    """Batch ASR: wav files -> log-mel -> encoder -> KV-cached greedy
    decode -> ``{model_name, num_clips, elapsed_s, transcripts}`` (written
    to ``output`` when given).  ``inputs`` are wav paths and directories
    (searched for ``*.wav``), resampled to 16 kHz; ``num_synthetic`` adds
    30 s clips of 0.1 x normal noise from ``default_rng(0)``.  Each clip
    is padded or trimmed to 30 s.  ``random_whisper`` makes the weights on
    the device from a generator seeded 0; otherwise they come from the
    local snapshot (``load_pretrained`` raises without one), and so does
    the tokenizer when ``transformers`` can read it (then the transcripts
    carry text too)."""
    dev = resolve_device(device)
    t0 = time.time()
    if random_whisper:
        arch = arch_for(model_name)
        params = init_whisper(torch.Generator(device=dev).manual_seed(0), arch)
    else:
        params, arch = load_pretrained(model_name)
        params = params_to(params, dev)

    tokenizer = None
    forced_ids = None
    if not random_whisper:
        try:
            from transformers import WhisperTokenizer

            tokenizer = WhisperTokenizer.from_pretrained(str(_hf_snapshot(model_name)),
                                                         local_files_only=True)
            forced_ids = tuple(tok for _, tok in sorted(tokenizer.get_decoder_prompt_ids()))
        except Exception as e:  # no transformers, or no tokenizer files in the snapshot
            print(f"tokenizer unavailable ({e}); writing token ids only", file=sys.stderr)

    names: list[str] = []
    clips: list[np.ndarray] = []
    n_samples = 30 * SAMPLE_RATE
    for spec in inputs or []:
        p = Path(spec)
        for wav in (sorted(p.glob("*.wav")) if p.is_dir() else [p]):
            audio, rate = read_wav(wav)
            if rate != SAMPLE_RATE:
                audio = resample(audio, rate, SAMPLE_RATE)
            names.append(str(wav))
            clips.append(np.asarray(audio, np.float32))
    rng = np.random.default_rng(0)
    for i in range(num_synthetic):
        names.append(f"synthetic_{i}")
        clips.append(rng.standard_normal(n_samples).astype(np.float32) * 0.1)
    if not clips:
        raise ValueError("no inputs: pass wav paths/dirs or --num-synthetic")

    def pad_or_trim(a: np.ndarray) -> np.ndarray:
        return a[:n_samples] if len(a) >= n_samples else np.pad(a, (0, n_samples - len(a)))

    results: dict[str, dict] = {}
    for lo in range(0, len(clips), batch_size):
        rows = [pad_or_trim(c) for c in clips[lo:lo + batch_size]]
        n_real = len(rows)
        # a ragged final batch is padded with silence to the batch shape,
        # as the JAX job does for its one compiled shape
        if n_real < batch_size and lo > 0:
            rows += [np.zeros(n_samples, np.float32)] * (batch_size - n_real)
        mel = log_mel_spectrogram(np.stack(rows), n_mels=arch.n_mels, device=dev)
        ids = greedy_decode_cached(params, mel, arch, max_len=max_len,
                                   forced_ids=forced_ids)[:n_real].cpu().numpy()
        texts = (tokenizer.batch_decode(ids, skip_special_tokens=True)
                 if tokenizer is not None else [None] * len(ids))
        for name, row, text in zip(names[lo:lo + batch_size], ids, texts):
            toks = row.tolist()
            while len(toks) > 1 and toks[-1] == arch.eos_token_id:  # the trailing EOS run
                toks.pop()
            entry: dict = {"token_ids": toks}
            if text is not None:
                entry["text"] = text
            results[name] = entry

    out = {
        "model_name": model_name,
        "num_clips": len(clips),
        "elapsed_s": round(time.time() - t0, 1),
        "transcripts": results,
    }
    if output:
        Path(output).parent.mkdir(parents=True, exist_ok=True)
        Path(output).write_text(json.dumps(out, indent=2))
        print(f"wrote {output}")
    return out


def _train_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--component", default="encoder")
    sp.add_argument("--model-name", default="openai/whisper-tiny")
    sp.add_argument("--expansion-factor", type=int, default=8)
    sp.add_argument("--k", type=int, default=32)
    sp.add_argument("--batch-size", type=int, default=4096)
    sp.add_argument("--learning-rate", type=float, default=1e-4)
    sp.add_argument("--epochs", type=int, default=10)
    sp.add_argument("--cache-dir", default=str(CACHE_DIR))
    sp.add_argument("--output-dir", default=str(OUTPUT_DIR))
    sp.add_argument("--experiment-name", default="launch")
    sp.add_argument("--checkpoint-every", type=int, default=None)
    sp.add_argument("--no-resume", action="store_true")
    sp.add_argument("--matmul-precision", default="default",
                    choices=["default", "high", "highest"],
                    help="kept for the JAX launcher's schema; the port's f32 products are "
                         "true f32 whatever it says")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")


def _add_supervise_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--supervise", action="store_true",
                    help="run the job under a restart supervisor: a crashed run relaunches "
                         "and resumes from its newest checkpoint")
    sp.add_argument("--max-restarts", type=int, default=3)
    sp.add_argument("--restart-backoff", type=float, default=10.0,
                    help="linear backoff between restarts, seconds")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("extract")
    pe.add_argument("--model-name", default="openai/whisper-tiny")
    pe.add_argument("--layers-encoder", default="0,1,2,3")
    pe.add_argument("--layers-decoder", default="0,1,2,3")
    pe.add_argument("--max-samples", type=int, default=1000)
    pe.add_argument("--batch-size", type=int, default=64)
    pe.add_argument("--dataset", default="librispeech_asr",
                    help="'synthetic', or a LibriSpeech name read from its mel cache")
    pe.add_argument("--cache-dir", default=str(CACHE_DIR))
    pe.add_argument("--random-whisper", action="store_true")
    pe.add_argument("--capture-mlp", action="store_true",
                    help="also cache per-layer (mlp_in, mlp_out) pairs (transcoder training data)")
    pe.add_argument("--checkpoint-every", type=int, default=2048,
                    help="checkpoint extraction progress every N samples (0 disables)")
    pe.add_argument("--cache-dtype", default=None, choices=["float32", "bfloat16"])
    pe.add_argument("--no-resume", action="store_true",
                    help="ignore a previous run's extraction progress")
    pe.add_argument("--device", default=None, help="cuda (default) or cpu")
    _add_supervise_flags(pe)

    pt = sub.add_parser("train", help="train a TopK SAE on one cached layer, or every listed "
                                      "layer with --all-layers")
    _train_flags(pt)
    pt.add_argument("--layer-idx", type=int, default=0)
    pt.add_argument("--all-layers", action="store_true")
    pt.add_argument("--layers-encoder", default="0,1,2,3")
    pt.add_argument("--layers-decoder", default="0,1,2,3")
    _add_supervise_flags(pt)

    px = sub.add_parser("train-transcoder",
                        help="train a transcoder on captured (mlp_in, mlp_out) pairs")
    _train_flags(px)
    px.add_argument("--layer-idx", type=int, default=0)
    px.add_argument("--max-resident-gb", type=float, default=8.0,
                    help="load the caches whole up to this many GB; above it, stream them "
                         "from the shards")
    px.add_argument("--no-skip", action="store_true",
                    help="plain TopK transcoder (default: Skip variant)")
    _add_supervise_flags(px)

    pc = sub.add_parser("train-crosscoder",
                        help="train a cross-layer crosscoder on several layers' caches")
    _train_flags(pc)
    pc.add_argument("--layers", default="0,1,2,3")
    pc.add_argument("--max-resident-gb", type=float, default=8.0,
                    help="load the caches whole up to this many GB; above it, stream them "
                         "from the shards")
    pc.add_argument("--relu", action="store_true",
                    help="ReLU + decoder-norm-weighted L1 variant (default TopK)")
    _add_supervise_flags(pc)

    pa = sub.add_parser("analyze", help="top-activating examples of a trained coder over its "
                                        "activation cache, and feature reports")
    pa.add_argument("--component", default="encoder")
    pa.add_argument("--layer-idx", type=int, default=0)
    pa.add_argument("--model-name", default="openai/whisper-tiny")
    pa.add_argument("--run-dir", default=None,
                    help="trained run dir (default: "
                         "<output-dir>/<experiment-name>_<component>_layer<N>)")
    pa.add_argument("--top-k", type=int, default=20, help="tracked examples per feature")
    pa.add_argument("--top-n", type=int, default=100,
                    help="features with per-feature report files")
    pa.add_argument("--batch-samples", type=int, default=8)
    pa.add_argument("--cache-dir", default=str(CACHE_DIR))
    pa.add_argument("--output-dir", default=str(OUTPUT_DIR))
    pa.add_argument("--experiment-name", default="launch")
    pa.add_argument("--job-type", default="sae", choices=["sae", "transcoder", "crosscoder"],
                    help="a trained SAE over its layer cache, a trained transcoder over the "
                         "mlp_in cache, or a trained crosscoder over stacked layer caches")
    pa.add_argument("--layers", default="0,1,2,3", help="crosscoder: the run's layer list")
    pa.add_argument("--dashboard", action="store_true",
                    help="also render a self-contained dashboard.html over the reports")
    pa.add_argument("--clips", type=int, default=0,
                    help="also extract audio clips of the top N features into <analysis>/audio")
    pa.add_argument("--clips-per-feature", type=int, default=3)
    pa.add_argument("--coactivation", type=int, default=0,
                    help="also compute co-activation (Jaccard) stats of the top N features")
    pa.add_argument("--auto-label", action="store_true",
                    help="attach lexical auto-labels from top-example transcriptions")
    pa.add_argument("--device", default=None, help="cuda (default) or cpu")

    pv = sub.add_parser("causal-validate", help="substitution effect and an optional "
                                                "per-feature ablation sweep of a trained SAE")
    pv.add_argument("--component", default="encoder")
    pv.add_argument("--layer-idx", type=int, default=0)
    pv.add_argument("--model-name", default="openai/whisper-tiny")
    pv.add_argument("--run-dir", default=None)
    pv.add_argument("--num-samples", type=int, default=4)
    pv.add_argument("--sweep-features", type=int, default=0,
                    help="also ablate the top N features one at a time")
    pv.add_argument("--random-whisper", action="store_true")
    pv.add_argument("--cache-dir", default=str(CACHE_DIR))
    pv.add_argument("--output-dir", default=str(OUTPUT_DIR))
    pv.add_argument("--experiment-name", default="launch")
    pv.add_argument("--device", default=None, help="cuda (default) or cpu")

    pr = sub.add_parser("transcribe", help="batch ASR: wav files/dirs -> greedy transcripts.json")
    pr.add_argument("inputs", nargs="*", help="wav files and/or directories of *.wav")
    pr.add_argument("--model-name", default="openai/whisper-tiny")
    pr.add_argument("--random-whisper", action="store_true")
    pr.add_argument("--max-len", type=int, default=224)
    pr.add_argument("--batch-size", type=int, default=16)
    pr.add_argument("--num-synthetic", type=int, default=0)
    pr.add_argument("--output", default=None,
                    help="transcripts JSON path (default: print summary only)")
    pr.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict | list:
    """Run one job; prints and returns its result.  With ``--supervise``
    the job runs in a child process under :func:`_supervise` (the attempts
    go to ``<cache-dir>/extract_supervisor_log.json`` or
    ``<output-dir>/<experiment-name>_supervisor_log.json``); a last
    failed attempt exits with its code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if getattr(args, "supervise", False):
        child = [sys.executable, "-m", "whisper_sae_tpu_torch.launch",
                 *_strip_supervise_args(argv)]
        if args.cmd == "extract":
            log = Path(args.cache_dir) / "extract_supervisor_log.json"
        else:
            log = Path(args.output_dir) / f"{args.experiment_name}_supervisor_log.json"
        rc = _supervise(child, max_restarts=args.max_restarts, backoff_s=args.restart_backoff,
                        log_path=log)
        if rc:
            raise SystemExit(rc)
        return {"supervisor_log": str(log), "returncode": rc}
    if args.cmd == "extract":
        out = extract_features(
            model_name=args.model_name, layers_encoder=args.layers_encoder,
            layers_decoder=args.layers_decoder, max_samples=args.max_samples,
            batch_size=args.batch_size, dataset=args.dataset, cache_dir=args.cache_dir,
            random_whisper=args.random_whisper, capture_mlp=args.capture_mlp,
            checkpoint_every=args.checkpoint_every or None, auto_resume=not args.no_resume,
            cache_dtype=args.cache_dtype, device=args.device,
        )
    elif args.cmd == "transcribe":
        out = transcribe_job(
            inputs=args.inputs, model_name=args.model_name, random_whisper=args.random_whisper,
            max_len=args.max_len, batch_size=args.batch_size, num_synthetic=args.num_synthetic,
            output=args.output, device=args.device,
        )
        out = {k: v for k, v in out.items() if k != "transcripts"}
    elif args.cmd == "analyze":
        out = analyze(
            component=args.component, layer_idx=args.layer_idx, model_name=args.model_name,
            run_dir=args.run_dir, top_k=args.top_k, top_n=args.top_n,
            batch_samples=args.batch_samples, cache_dir=args.cache_dir,
            output_dir=args.output_dir, experiment_name=args.experiment_name,
            dashboard=args.dashboard, job_type=args.job_type, layers=args.layers,
            clips=args.clips, clips_per_feature=args.clips_per_feature,
            coactivation=args.coactivation, auto_label=args.auto_label, device=args.device,
        )
    elif args.cmd == "causal-validate":
        out = causal_validate(
            component=args.component, layer_idx=args.layer_idx, model_name=args.model_name,
            run_dir=args.run_dir, num_samples=args.num_samples,
            sweep_features=args.sweep_features, random_whisper=args.random_whisper,
            cache_dir=args.cache_dir, output_dir=args.output_dir,
            experiment_name=args.experiment_name, device=args.device,
        )
        out = {k: v for k, v in out.items() if k != "ablation_sweep"}
    elif args.cmd == "train":
        common = dict(
            model_name=args.model_name, expansion_factor=args.expansion_factor, k=args.k,
            batch_size=args.batch_size, learning_rate=args.learning_rate, epochs=args.epochs,
            cache_dir=args.cache_dir, output_dir=args.output_dir,
            experiment_name=args.experiment_name, checkpoint_every=args.checkpoint_every,
            auto_resume=not args.no_resume, matmul_precision=args.matmul_precision,
            device=args.device,
        )
        if args.all_layers:
            out = train_all_layers(layers_encoder=args.layers_encoder,
                                   layers_decoder=args.layers_decoder, **common)
        else:
            out = train_sae(component=args.component, layer_idx=args.layer_idx, **common)
    else:
        common = dict(
            component=args.component, model_name=args.model_name,
            expansion_factor=args.expansion_factor, k=args.k, batch_size=args.batch_size,
            learning_rate=args.learning_rate, epochs=args.epochs, cache_dir=args.cache_dir,
            output_dir=args.output_dir, experiment_name=args.experiment_name,
            checkpoint_every=args.checkpoint_every, auto_resume=not args.no_resume,
            matmul_precision=args.matmul_precision,
            max_resident_bytes=int(args.max_resident_gb * (1 << 30)), device=args.device,
        )
        if args.cmd == "train-transcoder":
            out = train_transcoder(layer_idx=args.layer_idx, use_skip=not args.no_skip, **common)
        else:
            out = train_crosscoder(layers=args.layers, use_topk=not args.relu, **common)
    if is_primary():
        print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
