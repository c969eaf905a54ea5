"""Train TopK SAEs from a cached Whisper layer, on the card.

The port's counterpart of ``scripts/train.py`` (same flags, same
``train_layer`` flow: cache -> ``create_sae`` -> ``SAETrainer.train`` ->
``sae_final.*`` and ``metrics.json``)::

    python -m whisper_sae_tpu_torch.train --config configs/tiny_default.yaml \\
        --layer encoder:0 --no-wandb
    python -m whisper_sae_tpu_torch.train --device cpu ...   # plain versions

Feature extraction is not ported yet: a missing cache, ``--extract-only``
or ``--random-whisper`` exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .config import ExperimentConfig
from .data.feature_cache import FeatureCache
from .models.sae import create_sae
from .training.trainer import SAETrainer
from .utils.device import resolve_device

_NOT_PORTED = "extraction is not ported yet"


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
                        help="Extract features only (not ported yet)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=None, help="Random seed (overrides config)")
    parser.add_argument("--resume", type=Path, default=None,
                        help="Resume training from a checkpoint file")
    parser.add_argument("--random-whisper", action="store_true",
                        help="Random Whisper weights for extraction (not ported yet)")
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

    missing = [f"{c}:{i}" for c, i in layers if not feature_cache.has_cache(c, i)]
    if args.extract_only or args.random_whisper or missing:
        why = f"no cached features for {', '.join(missing)}" if missing else "extraction requested"
        sys.exit(f"{_NOT_PORTED} ({why}); extract with scripts/train.py first")

    trainers = {}
    for component, layer_idx in layers:
        run_name = f"{config.experiment_name}_{component}_layer{layer_idx}"
        trainers[run_name] = train_layer(config, feature_cache, component, layer_idx, run_name,
                                         device, args.resume)
    print("Training complete!")
    return trainers


def train_layer(config: ExperimentConfig, feature_cache: FeatureCache, component: str,
                layer_idx: int, run_name: str, device: torch.device,
                resume: Path | None = None) -> SAETrainer:
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
