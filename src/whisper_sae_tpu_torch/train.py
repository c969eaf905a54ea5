"""Extract Whisper activations and train TopK SAEs on them, on the card.

The port's counterpart of ``scripts/train.py`` (same flags, same flow):
a layer without a cache (or ``--extract-only``) first runs extraction --
the port's log-mel, the Whisper encoder through the fused kernels in bf16
under ``use_amp``, the decoder on one BOS token, batch 64 -- into the
JAX package's cache format; then each layer trains from its cache
(``create_sae`` -> ``SAETrainer.train`` -> ``sae_final.*`` and
``metrics.json``); a cache of more than one shard streams from disk
batch by batch (a prefetching shard loader) and resamples from a bounded
subsample, as the JAX CLI does::

    python -m whisper_sae_tpu_torch.train --config configs/tiny_default.yaml \
        --layer encoder:0 --no-wandb
    python -m whisper_sae_tpu_torch.train --config ... --extract-only --random-whisper
    python -m whisper_sae_tpu_torch.train --device cpu ...   # plain versions
    python -m whisper_sae_tpu_torch.train ... --profile profiles/run1   # Chrome trace

Without ``--random-whisper`` the pretrained weights are loaded from the
local HF cache, with a fallback to random weights.  Only
``dataset_name: synthetic`` is ported (LibriSpeech streaming is not).
"""

from __future__ import annotations

import argparse
import json
import random
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .config import ExperimentConfig
from .data.feature_cache import FeatureCache, extract_and_cache_features
from .data.librispeech import AudioBatchLoader, LibriSpeechFeaturesOnly, SyntheticSpeechDataset
from .models.sae import create_sae
from .models.whisper import arch_for, init_whisper, load_pretrained
from .training.trainer import SAETrainer
from .utils.device import resolve_device
from .utils.profiling import trace

EXTRACT_BATCH = 64


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train Sparse Autoencoders on cached Whisper activations (PyTorch/CUDA)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__,
    )
    parser.add_argument("--config", type=Path, default=Path("configs/tiny_default.yaml"),
                        help="Path to configuration YAML file")
    parser.add_argument("--layer", type=str, default=None,
                        help="Train single layer (format: encoder:0 or decoder:2)")
    parser.add_argument("--no-wandb", action="store_true", help="Disable W&B logging")
    parser.add_argument("--extract-only", action="store_true",
                        help="Extract features only, don't train SAEs")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=None, help="Random seed (overrides config)")
    parser.add_argument("--resume", type=Path, default=None,
                        help="Resume training from a checkpoint file")
    parser.add_argument("--random-whisper", action="store_true",
                        help="Use randomly initialised Whisper weights (offline mode)")
    parser.add_argument("--profile", type=Path, default=None,
                        help="Write a torch.profiler trace (Chrome JSON) of training into "
                             "this directory")
    return parser.parse_args(argv)


def parse_layer_arg(layer_arg: str) -> tuple[str, int]:
    """'encoder:0' -> ('encoder', 0)."""
    parts = layer_arg.split(":")
    if len(parts) != 2:
        raise ValueError(f"Invalid layer format: {layer_arg}. Use encoder:N or decoder:N")
    if parts[0] not in ("encoder", "decoder"):
        raise ValueError(f"Invalid component: {parts[0]}. Use encoder or decoder")
    return parts[0], int(parts[1])


def main(argv=None) -> dict[str, SAETrainer]:
    """Run the CLI; returns the trainers by run name."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    config = ExperimentConfig.from_yaml(args.config) if args.config.exists() else ExperimentConfig()
    print(f"Loaded config from {args.config}" if args.config.exists() else "Using default configuration")
    if args.seed is not None:
        config.training.seed = args.seed
    if args.no_wandb:
        config.wandb.enabled = False
    random.seed(config.training.seed)
    np.random.seed(config.training.seed)
    torch.manual_seed(config.training.seed)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Using device: {device} ({name})")

    feature_cache = FeatureCache(
        cache_dir=Path(config.data.cache_dir) / "features",
        whisper_config=config.whisper,
        data_config=config.data,
    )
    encoder_layers = list(config.encoder_layers)
    decoder_layers = list(config.decoder_layers)
    if args.layer:
        component, layer_idx = parse_layer_arg(args.layer)
        encoder_layers = [layer_idx] if component == "encoder" else []
        decoder_layers = [layer_idx] if component == "decoder" else []
    layers = [("encoder", i) for i in encoder_layers] + [("decoder", i) for i in decoder_layers]

    if args.extract_only or any(not feature_cache.has_cache(c, i) for c, i in layers):
        extract(config, feature_cache, encoder_layers, decoder_layers, device, args.random_whisper)
    if args.extract_only:
        print("Extract-only mode, skipping training")
        return {}

    trainers = {}
    for component, layer_idx in layers:
        run_name = f"{config.experiment_name}_{component}_layer{layer_idx}"
        trainers[run_name] = train_layer(config, feature_cache, component, layer_idx, run_name,
                                         device, args.resume, args.profile)
    print("Training complete!")
    return trainers


def extract(config: ExperimentConfig, feature_cache: FeatureCache, encoder_layers: list[int],
            decoder_layers: list[int], device: torch.device, random_whisper: bool) -> None:
    """Write the caches of the given layers (``scripts/train.py:155-196``)."""
    if config.data.dataset_name != "synthetic":
        raise ValueError(
            f"dataset_name {config.data.dataset_name!r} is not ported: the port extracts from "
            "dataset_name: synthetic only (LibriSpeech streaming needs data that is not here)")
    arch = arch_for(config.whisper.model_name)
    gen = torch.Generator(device=device).manual_seed(config.training.seed)  # made on the card
    if random_whisper:
        params = init_whisper(gen, arch)
        print("Using RANDOM Whisper weights (--random-whisper)")
    else:
        try:
            params, arch = load_pretrained(config.whisper.model_name)
            print(f"Loaded {config.whisper.model_name}")
        except Exception as e:  # offline without a local snapshot
            print(f"Pretrained load failed ({type(e).__name__}); falling back to random "
                  "weights. Pass --random-whisper to silence this warning.")
            params = init_whisper(gen, arch)
    print("Extracting features...")
    dataset = SyntheticSpeechDataset(num_samples=config.data.max_samples,
                                     seed=config.training.seed, n_mels=arch.n_mels, device=device)
    loader = AudioBatchLoader(LibriSpeechFeaturesOnly(dataset), batch_size=EXTRACT_BATCH)
    extract_and_cache_features(
        params, arch, loader, feature_cache, encoder_layers=encoder_layers,
        decoder_layers=decoder_layers, max_samples=config.data.max_samples,
        compute_dtype=torch.bfloat16 if config.training.use_amp else None, device=device,
    )
    print("Feature extraction complete")


def train_layer(config: ExperimentConfig, feature_cache: FeatureCache, component: str,
                layer_idx: int, run_name: str, device: torch.device,
                resume: Path | None = None, profile: Path | None = None) -> SAETrainer:
    print(f"Training SAE for {component} layer {layer_idx}")
    metadata = feature_cache.load_metadata(component, layer_idx)
    print(f"Cached {metadata.num_tokens:,} tokens, dim={metadata.hidden_dim}, dtype={metadata.dtype}")
    sae = create_sae(config.sae, input_dim=metadata.hidden_dim, seed=config.training.seed,
                     device=device)
    print(f"Created SAE: {metadata.hidden_dim} -> {sae.hidden_dim} (k={config.sae.k})")
    dataloader = feature_cache.get_dataloader(
        component=component, layer_idx=layer_idx, batch_size=config.training.batch_size,
        shuffle=True, seed=config.training.seed,
    )
    run_dir = Path(config.output_dir) / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    trainer = SAETrainer(model=sae, config=config.training, run_dir=run_dir)
    if config.sae.dead_feature_resample:
        if hasattr(dataloader, "reader"):
            # a multi-shard cache streams: resample from a bounded sorted
            # subsample of 8 resample batches (scripts/train.py:231-240)
            idx = np.random.default_rng(config.training.seed).permutation(
                metadata.num_tokens)[:8 * trainer.resample_batch_size]
            trainer.set_resample_dataset(dataloader.reader.gather(np.sort(idx)))
        else:
            trainer.set_resample_dataset(dataloader.data)
    if resume is not None:
        trainer.load_checkpoint(resume)
        print(f"Resumed from {resume} (step {trainer.global_step})")

    if config.wandb.enabled:
        try:
            import wandb

            trainer.wandb_run = wandb.init(
                project=config.wandb.project,
                entity=config.wandb.entity,
                name=run_name,
                tags=config.wandb.tags + [component, f"layer{layer_idx}"],
                config={
                    "whisper": config.whisper.model_dump(),
                    "sae": config.sae.model_dump(),
                    "training": config.training.model_dump(),
                    "component": component,
                    "layer_idx": layer_idx,
                },
            )
        except Exception as e:  # W&B is optional: train on without it
            print(f"W&B initialization failed: {e}\nContinuing without W&B logging...")

    print(f"Training for {config.training.epochs} epochs...")
    with trace(profile):
        trainer.train(dataloader, epochs=config.training.epochs)
    trainer.save_final()
    trainer.save_metrics()
    (run_dir / "training_config.json").write_text(json.dumps({
        "sae": json.loads(config.sae.model_dump_json()),
        "training": json.loads(config.training.model_dump_json()),
        "whisper": json.loads(config.whisper.model_dump_json()),
        "component": component,
        "layer_idx": layer_idx,
        "finished_at": datetime.now().isoformat(),
    }, indent=2))
    print(f"Saved model and metrics to {run_dir}")
    if trainer.wandb_run is not None:
        trainer.wandb_run.finish()
    return trainer


if __name__ == "__main__":
    main()
