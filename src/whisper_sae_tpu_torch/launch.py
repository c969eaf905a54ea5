"""Job launcher of the port (counterpart of ``launcher/launch.py``): the
extraction job and the transcoder and crosscoder training jobs, with the
JAX launcher's flags, defaults, run directories and output files::

    python -m whisper_sae_tpu_torch.launch extract --capture-mlp --random-whisper \\
        --dataset synthetic --max-samples 64 --layers-encoder 0,1,2,3 --layers-decoder ""
    python -m whisper_sae_tpu_torch.launch train-transcoder --component encoder --layer-idx 0
    python -m whisper_sae_tpu_torch.launch train-crosscoder --layers 0,1,2,3 [--relu]

Every job runs on the card unless ``--device cpu`` is given (then the
kernels' plain versions run).  Only ``--dataset synthetic`` is ported.
Training jobs resume from the newest ``checkpoint_epoch*.npz`` of their
run directory unless ``--no-resume``, and load their caches whole: a
cache larger than ``--max-resident-gb`` raises.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from datetime import datetime
from pathlib import Path

import torch

from .config import DataConfig, TrainingConfig, WhisperConfig
from .data.feature_cache import FeatureCache, extract_and_cache_features
from .data.librispeech import AudioBatchLoader, LibriSpeechFeaturesOnly, SyntheticSpeechDataset
from .data.loader import ActivationLoader, PairedActivationLoader
from .models.crosscoder import create_crosscoder
from .models.transcoder import create_transcoder
from .models.whisper import arch_for, init_whisper, load_pretrained
from .training.coder_trainers import CrosscoderTrainer, TranscoderTrainer
from .utils.checkpoint import save_pytree
from .utils.device import resolve_device

CACHE_DIR = Path("cache")
OUTPUT_DIR = Path("outputs")


def _parse_layers(spec: str) -> list[int]:
    return [int(x) for x in spec.split(",") if x != ""]


def _latest_checkpoint(run_dir: Path) -> Path | None:
    ckpts = []
    for p in run_dir.glob("checkpoint_epoch*.npz"):
        m = re.search(r"epoch(\d+)", p.name)
        if m:
            ckpts.append((int(m.group(1)), p))
    return max(ckpts)[1] if ckpts else None


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
    if dataset != "synthetic":
        raise ValueError(f"dataset {dataset!r} is not ported: the port extracts from "
                         "--dataset synthetic only (LibriSpeech streaming needs data that is "
                         "not here)")
    t0 = time.time()
    enc_layers = _parse_layers(layers_encoder)
    dec_layers = _parse_layers(layers_decoder)
    whisper_cfg = WhisperConfig(model_name=model_name)
    data_cfg = DataConfig(dataset_name=dataset, max_samples=max_samples, cache_dir=Path(cache_dir))
    arch = arch_for(model_name)
    gen = torch.Generator().manual_seed(seed)
    if random_whisper:
        params = init_whisper(gen, arch)
    else:
        try:
            params, arch = load_pretrained(model_name)
        except Exception:  # offline without a local snapshot
            print("pretrained load failed; using random weights", file=sys.stderr)
            params = init_whisper(gen, arch)
    features_only = LibriSpeechFeaturesOnly(
        SyntheticSpeechDataset(num_samples=max_samples, seed=seed, n_mels=arch.n_mels, device=dev),
        record_texts=True)
    cache = FeatureCache(Path(cache_dir) / "features", whisper_cfg, data_cfg)
    extract_and_cache_features(
        params, arch, AudioBatchLoader(features_only, batch_size=batch_size), cache,
        encoder_layers=enc_layers, decoder_layers=dec_layers, max_samples=max_samples,
        compute_dtype=torch.bfloat16, capture_mlp=capture_mlp,
        checkpoint_every=checkpoint_every, resume=auto_resume, cache_dtype=cache_dtype,
        device=dev,
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
    (features / "extraction_log.json").write_text(json.dumps(log, indent=2))
    (features / "metadata.json").write_text(json.dumps({
        "model_name": model_name,
        "layers": {"encoder": enc_layers, "decoder": dec_layers},
        "created_at": datetime.now().isoformat(),
    }, indent=2))
    return log


def _load_whole(cache: FeatureCache, component: str, layer_idx: int, max_resident_bytes: int,
                used: int) -> tuple[torch.Tensor, object]:
    """One cache as a CPU tensor, refusing to exceed ``max_resident_bytes``
    with what is already loaded (``used`` bytes)."""
    meta = cache.load_metadata(component, layer_idx)
    nbytes = meta.num_tokens * meta.hidden_dim * (2 if meta.dtype == "bfloat16" else 4)
    if used + nbytes > max_resident_bytes:
        raise ValueError(
            f"the caches need {(used + nbytes) / 2**30:.2f} GB resident, above --max-resident-gb "
            f"{max_resident_bytes / 2**30:.2f}: the port loads caches whole (out-of-core "
            "training is not ported yet)")
    return cache.load(component, layer_idx)


def _run(trainer, loader, epochs: int, checkpoint_every: int | None, run_dir: Path,
         auto_resume: bool) -> str | None:
    resumed_from = None
    if auto_resume:
        ckpt = _latest_checkpoint(run_dir)
        if ckpt is not None:
            trainer.load_checkpoint(ckpt)
            resumed_from = ckpt.name
            print(f"resuming from {ckpt} (epoch {trainer.epoch}, step {trainer.global_step})",
                  file=sys.stderr)
    trainer.train(loader, epochs=epochs, checkpoint_every=checkpoint_every)
    return resumed_from


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
    x, meta = _load_whole(cache, f"{component}_mlp_in", layer_idx, max_resident_bytes, 0)
    y, _ = _load_whole(cache, f"{component}_mlp_out", layer_idx, max_resident_bytes,
                       x.numel() * x.element_size())
    train_cfg = TrainingConfig(batch_size=batch_size, learning_rate=learning_rate, epochs=epochs,
                              warmup_steps=warmup_steps, use_amp=use_amp, seed=seed,
                              matmul_precision=matmul_precision)
    hidden_dim = expansion_factor * meta.hidden_dim
    model = create_transcoder(meta.hidden_dim, meta.hidden_dim, hidden_dim, k=k,
                              use_skip=use_skip, seed=seed, device=dev)
    if use_skip:
        model.set_output_bias(y.float().mean(dim=0))
    run_dir = Path(output_dir) / f"{experiment_name}_{component}_transcoder_layer{layer_idx}"
    run_dir.mkdir(parents=True, exist_ok=True)
    trainer = TranscoderTrainer(model, train_cfg, run_dir=run_dir)
    loader = PairedActivationLoader(x, y, batch_size=batch_size, seed=seed)
    trainer.set_resample_dataset(loader.data)
    resumed_from = _run(trainer, loader, epochs, checkpoint_every, run_dir, auto_resume)
    save_pytree(run_dir / "transcoder_final.npz", trainer.model.params)
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
    feats, meta, used = [], None, 0
    for layer in layer_list:
        if not cache.has_cache(component, layer):
            raise FileNotFoundError(
                f"no cached features for {component} layer {layer}; run extract first")
        f, meta = _load_whole(cache, component, layer, max_resident_bytes, used)
        used += f.numel() * f.element_size()
        feats.append(f)
    train_cfg = TrainingConfig(batch_size=batch_size, learning_rate=learning_rate, epochs=epochs,
                              warmup_steps=warmup_steps, use_amp=use_amp, seed=seed,
                              matmul_precision=matmul_precision)
    d_sae = expansion_factor * meta.hidden_dim
    model = create_crosscoder(meta.hidden_dim, len(layer_list), d_sae, k=k, use_topk=use_topk,
                              layer_indices=layer_list, seed=seed, device=dev)
    run_dir = Path(output_dir) / (
        f"{experiment_name}_{component}_crosscoder_l{'-'.join(map(str, layer_list))}")
    run_dir.mkdir(parents=True, exist_ok=True)
    trainer = CrosscoderTrainer(model, train_cfg, run_dir=run_dir)
    loader = ActivationLoader(torch.stack(feats, dim=1), batch_size=batch_size, seed=seed)
    del feats
    resumed_from = _run(trainer, loader, epochs, checkpoint_every, run_dir, auto_resume)
    save_pytree(run_dir / "crosscoder_final.npz", trainer.model.params)
    trainer.save_metrics()
    result = {
        "component": component,
        "layers": layer_list,
        "num_tokens": int(loader.num_tokens),
        "final_loss": trainer.metrics_history[-1].loss if trainer.metrics_history else None,
        "elapsed_s": round(time.time() - t0, 1),
        "run_dir": str(run_dir),
        "resumed_from": resumed_from,
    }
    (run_dir / "training_config.json").write_text(json.dumps({
        "crosscoder": {"d_model": meta.hidden_dim, "n_layers": len(layer_list), "d_sae": d_sae,
                       "k": k, "use_topk": use_topk, "layer_indices": layer_list},
        "training": json.loads(train_cfg.model_dump_json()),
        "whisper": json.loads(whisper_cfg.model_dump_json()),
        "component": component,
        "finished_at": datetime.now().isoformat(),
    }, indent=2))
    return result


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
    sp.add_argument("--max-resident-gb", type=float, default=8.0,
                    help="load the caches whole up to this many GB; larger caches raise")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")


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
                    help="only 'synthetic' is ported")
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

    px = sub.add_parser("train-transcoder",
                        help="train a transcoder on captured (mlp_in, mlp_out) pairs")
    _train_flags(px)
    px.add_argument("--layer-idx", type=int, default=0)
    px.add_argument("--no-skip", action="store_true",
                    help="plain TopK transcoder (default: Skip variant)")

    pc = sub.add_parser("train-crosscoder",
                        help="train a cross-layer crosscoder on several layers' caches")
    _train_flags(pc)
    pc.add_argument("--layers", default="0,1,2,3")
    pc.add_argument("--relu", action="store_true",
                    help="ReLU + decoder-norm-weighted L1 variant (default TopK)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run one job; prints and returns its result dict."""
    args = parse_args(argv)
    if args.cmd == "extract":
        out = extract_features(
            model_name=args.model_name, layers_encoder=args.layers_encoder,
            layers_decoder=args.layers_decoder, max_samples=args.max_samples,
            batch_size=args.batch_size, dataset=args.dataset, cache_dir=args.cache_dir,
            random_whisper=args.random_whisper, capture_mlp=args.capture_mlp,
            checkpoint_every=args.checkpoint_every or None, auto_resume=not args.no_resume,
            cache_dtype=args.cache_dtype, device=args.device,
        )
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
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
