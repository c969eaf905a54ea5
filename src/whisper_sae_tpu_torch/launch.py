"""Job launcher of the port (counterpart of ``launcher/launch.py``): the
extraction job, the transcoder and crosscoder training jobs and batch
transcription, with the JAX launcher's flags, defaults, run directories
and output files::

    python -m whisper_sae_tpu_torch.launch extract --capture-mlp --random-whisper \\
        --dataset synthetic --max-samples 64 --layers-encoder 0,1,2,3 --layers-decoder ""
    python -m whisper_sae_tpu_torch.launch train-transcoder --component encoder --layer-idx 0
    python -m whisper_sae_tpu_torch.launch train-crosscoder --layers 0,1,2,3 [--relu]
    python -m whisper_sae_tpu_torch.launch transcribe clips/ --random-whisper --output t.json

Every job runs on the card unless ``--device cpu`` is given (then the
kernels' plain versions run).  Only ``--dataset synthetic`` is ported.
Training jobs resume from the newest ``checkpoint_epoch*.npz`` of their
run directory unless ``--no-resume``.  They load their caches whole up to
``--max-resident-gb``; above it they stream from the shards, as the JAX
launcher's do (``launcher/launch.py:420-485``, ``:572-627``): the
transcoder as chunked epochs through a paired reader, the crosscoder
batch by batch through a multi-layer loader.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .config import DataConfig, TrainingConfig, WhisperConfig
from .data.feature_cache import FeatureCache, extract_and_cache_features
from .data.librispeech import AudioBatchLoader, LibriSpeechFeaturesOnly, SyntheticSpeechDataset
from .data.loader import ActivationLoader, MultiLayerLoader, PairedActivationLoader
from .models.crosscoder import create_crosscoder
from .models.transcoder import create_transcoder
from .data.mel import SAMPLE_RATE, log_mel_spectrogram
from .models.whisper import (
    _hf_snapshot, arch_for, greedy_decode_cached, init_whisper, load_pretrained, params_to,
)
from .training.coder_trainers import CrosscoderTrainer, TranscoderTrainer
from .utils.checkpoint import save_pytree
from .utils.device import resolve_device
from .utils.wavio import read_wav, resample

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
    gen = torch.Generator(device=dev).manual_seed(seed)  # weights made where they run
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
    trainer = TranscoderTrainer(model, train_cfg, run_dir=run_dir)
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
    trainer = CrosscoderTrainer(model, train_cfg, run_dir=run_dir)
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
    save_pytree(run_dir / "crosscoder_final.npz", trainer.model.params)
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
    (run_dir / "training_config.json").write_text(json.dumps({
        "crosscoder": {"d_model": meta.hidden_dim, "n_layers": len(layer_list), "d_sae": d_sae,
                       "k": k, "use_topk": use_topk, "layer_indices": layer_list},
        "training": json.loads(train_cfg.model_dump_json()),
        "whisper": json.loads(whisper_cfg.model_dump_json()),
        "component": component,
        "finished_at": datetime.now().isoformat(),
    }, indent=2))
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
    sp.add_argument("--max-resident-gb", type=float, default=8.0,
                    help="load the caches whole up to this many GB; above it, stream them "
                         "from the shards")
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
    elif args.cmd == "transcribe":
        out = transcribe_job(
            inputs=args.inputs, model_name=args.model_name, random_whisper=args.random_whisper,
            max_len=args.max_len, batch_size=args.batch_size, num_synthetic=args.num_synthetic,
            output=args.output, device=args.device,
        )
        out = {k: v for k, v in out.items() if k != "transcripts"}
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
