"""Top-activation tracking and feature reports (counterpart of
``whisper_sae_tpu/analysis/feature_viz.py``).

The same ``FeatureActivation`` schema and JSON round-trip, per-feature
top-k examples (k = 20 by default), 10 ms-a-frame timestamps, feature
stats, the ``summary.json`` / ``features/feature_{i:05d}.json`` /
``tracker_state.json`` report layout and ``collect_top_activations``.

The running top-k state is three ``[F, k]`` tensors on the tracker's
device (the card unless the caller asks for the CPU), and each batch is
one merge in plain PyTorch: mask to -inf, per-feature candidates over the
batch, concatenate with the state, top-k again.  ``jax.lax.top_k`` ranks
equal values by the lower index first and ``torch.topk`` promises no
order among ties (the -inf padding is one large tie), so both top-k's
rank int64 keys that hold the value's order in the high half and the
reversed index in the low half: every key is distinct, and the samples
and positions kept are JAX's on ties too.  Transcriptions and metadata
are joined on the host at read-out time through a per-sample registry.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device

MS_PER_FRAME = 10.0  # the reference's convention (10 ms a frame)


@dataclass
class FeatureActivation:
    """A single activation of a feature."""

    feature_idx: int
    activation_value: float
    sample_idx: int
    position_idx: int
    timestamp_ms: float | None = None
    transcription: str | None = None
    transcription_context: str | None = None
    audio_path: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "feature_idx": self.feature_idx,
            "activation_value": self.activation_value,
            "sample_idx": self.sample_idx,
            "position_idx": self.position_idx,
            "timestamp_ms": self.timestamp_ms,
            "transcription": self.transcription,
            "transcription_context": self.transcription_context,
            "audio_path": self.audio_path,
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureActivation":
        return cls(**d)


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """int64 keys of the last axis that rank as ``jax.lax.top_k`` does: by
    value, descending, then by the lower index (-0.0 counts as +0.0)."""
    bits = (values.float() + 0.0).contiguous().view(torch.int32)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    return mono * (1 << 32) + ((1 << 32) - 1 - idx)


def _top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, indices), descending,
    ties to the lower index."""
    idx = torch.topk(_order_keys(values), k, dim=-1).indices
    return torch.gather(values, -1, idx), idx


def _merge_topk(
    values: torch.Tensor,  # [F, k] running top values (-inf padded)
    samples: torch.Tensor,  # [F, k] int32
    positions: torch.Tensor,  # [F, k] int32
    acts: torch.Tensor,  # [N, F] batch activations (flattened over batch*seq)
    sample_ids: torch.Tensor,  # [N] int32
    position_ids: torch.Tensor,  # [N] int32
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    kc = min(k, acts.shape[0])
    masked = torch.where(acts > 0, acts, float("-inf")).t()  # [F, N]
    cand_v, cand_i = _top_k(masked, kc)  # [F, kc]
    all_v = torch.cat([values, cand_v], dim=1)
    all_s = torch.cat([samples, sample_ids[cand_i]], dim=1)
    all_p = torch.cat([positions, position_ids[cand_i]], dim=1)
    new_v, sel = _top_k(all_v, k)
    total = torch.sum(acts > 0)
    return new_v, torch.gather(all_s, 1, sel), torch.gather(all_p, 1, sel), total


class TopKTracker:
    """Running top-k of activating examples per feature, on ``device``."""

    def __init__(self, num_features: int, k: int = 20, device=None):
        self.num_features = num_features
        self.k = k
        self.device = resolve_device(device)
        self._values = torch.full((num_features, k), float("-inf"), device=self.device)
        self._samples = torch.zeros((num_features, k), dtype=torch.int32, device=self.device)
        self._positions = torch.zeros((num_features, k), dtype=torch.int32, device=self.device)
        self._sample_meta: dict[int, tuple[str | None, dict]] = {}
        self.total_activations = 0
        self.samples_processed = 0

    def update(
        self,
        activations,
        sample_indices,
        transcriptions: list[str] | None = None,
        metadata_list: list[dict] | None = None,
    ) -> None:
        """Merge a batch of activations ([B, F] or [B, S, F])."""
        acts = torch.as_tensor(activations).to(self.device, torch.float32)
        if acts.ndim == 2:
            acts = acts[:, None, :]
        b, s, f = acts.shape
        if f != self.num_features:
            raise ValueError(f"activations have {f} features, the tracker {self.num_features}")

        sample_indices = [int(i) for i in np.asarray(sample_indices).reshape(-1)]
        for j, si in enumerate(sample_indices):
            self._sample_meta[si] = (
                transcriptions[j] if transcriptions else None,
                dict(metadata_list[j]) if metadata_list else {},
            )

        sample_ids = torch.tensor(sample_indices, dtype=torch.int32,
                                  device=self.device).repeat_interleave(s)
        position_ids = torch.arange(s, dtype=torch.int32, device=self.device).repeat(b)
        flat = acts.reshape(b * s, f)
        self._values, self._samples, self._positions, total = _merge_topk(
            self._values, self._samples, self._positions,
            flat, sample_ids, position_ids, self.k,
        )
        self.total_activations += int(total)
        self.samples_processed += b

    def get_top_examples(self, feature_idx: int) -> list[FeatureActivation]:
        """Top-k examples, descending."""
        vals = self._values[feature_idx].cpu().numpy()
        samps = self._samples[feature_idx].cpu().numpy()
        poss = self._positions[feature_idx].cpu().numpy()
        out = []
        for v, si, pi in zip(vals, samps, poss):
            if not np.isfinite(v):
                continue
            transcription, metadata = self._sample_meta.get(int(si), (None, {}))
            out.append(
                FeatureActivation(
                    feature_idx=int(feature_idx),
                    activation_value=float(v),
                    sample_idx=int(si),
                    position_idx=int(pi),
                    timestamp_ms=float(pi) * MS_PER_FRAME,
                    transcription=transcription,
                    metadata=dict(metadata),
                )
            )
        out.sort(key=lambda x: x.activation_value, reverse=True)
        return out

    def get_all_top_examples(self) -> dict[int, list[FeatureActivation]]:
        return {i: self.get_top_examples(i) for i in range(self.num_features)}

    def get_feature_stats(self) -> dict[int, dict]:
        """Per-feature stats, vectorised over the state on the host."""
        vals = self._values.cpu().numpy()
        finite = np.isfinite(vals)
        n = finite.sum(axis=1)
        safe = np.where(finite, vals, 0.0)
        maxs = np.where(n > 0, vals.max(axis=1, initial=-np.inf), 0.0)
        mins = np.where(n > 0, np.where(finite, vals, np.inf).min(axis=1, initial=np.inf), 0.0)
        means = np.where(n > 0, safe.sum(axis=1) / np.maximum(n, 1), 0.0)
        return {
            i: {
                "num_examples": int(n[i]),
                "max_activation": float(maxs[i]) if n[i] else 0.0,
                "min_activation": float(mins[i]) if n[i] else 0.0,
                "mean_activation": float(means[i]) if n[i] else 0.0,
            }
            for i in range(self.num_features)
        }

    def save(self, path: Path | str) -> None:
        """JSON state dump (the JAX package's schema).

        One bulk pass: one device->host transfer, one vectorised per-row
        sort, plain dicts, one buffered write (a per-feature
        ``get_top_examples`` loop is minutes at whisper-large's 40960
        features).
        """
        vals = self._values.cpu().numpy()
        order = np.argsort(-vals, axis=1, kind="stable")
        rows = np.arange(vals.shape[0])[:, None]
        vals = vals[rows, order]
        samps = self._samples.cpu().numpy()[rows, order]
        poss = self._positions.cpu().numpy()[rows, order]
        finite = np.isfinite(vals)
        meta = self._sample_meta
        features = {}
        for i in np.nonzero(finite.any(axis=1))[0]:
            row = []
            for j in np.nonzero(finite[i])[0]:
                si = int(samps[i, j])
                transcription, md = meta.get(si, (None, {}))
                row.append(
                    {
                        "feature_idx": int(i),
                        "activation_value": float(vals[i, j]),
                        "sample_idx": si,
                        "position_idx": int(poss[i, j]),
                        "timestamp_ms": float(poss[i, j]) * MS_PER_FRAME,
                        "transcription": transcription,
                        "transcription_context": None,
                        "audio_path": None,
                        "metadata": md,
                    }
                )
            features[str(int(i))] = row
        data = {
            "num_features": self.num_features,
            "k": self.k,
            "total_activations": self.total_activations,
            "samples_processed": self.samples_processed,
            "features": features,
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @classmethod
    def load(cls, path: Path | str, device=None) -> "TopKTracker":
        with open(path) as f:
            data = json.load(f)
        tracker = cls(num_features=data["num_features"], k=data["k"], device=device)
        tracker.total_activations = data["total_activations"]
        tracker.samples_processed = data["samples_processed"]
        values = np.full((tracker.num_features, tracker.k), -np.inf, np.float32)
        samples = np.zeros((tracker.num_features, tracker.k), np.int32)
        positions = np.zeros((tracker.num_features, tracker.k), np.int32)
        for feat_str, examples in data["features"].items():
            fi = int(feat_str)
            for j, e in enumerate(examples[: tracker.k]):
                ex = FeatureActivation.from_dict(e)
                values[fi, j] = ex.activation_value
                samples[fi, j] = ex.sample_idx
                positions[fi, j] = ex.position_idx
                tracker._sample_meta[ex.sample_idx] = (ex.transcription, ex.metadata)
        tracker._values = torch.from_numpy(values).to(tracker.device)
        tracker._samples = torch.from_numpy(samples).to(tracker.device)
        tracker._positions = torch.from_numpy(positions).to(tracker.device)
        return tracker


@dataclass
class FeatureInterpretation:
    """Manual feature interpretation."""

    feature_idx: int
    category: str
    description: str
    confidence: float
    evidence: list[str] = field(default_factory=list)
    automated_labels: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "feature_idx": self.feature_idx,
            "category": self.category,
            "description": self.description,
            "confidence": self.confidence,
            "evidence": self.evidence,
            "automated_labels": self.automated_labels,
        }


class FeatureReport:
    """Interpretation reports:
    ``summary.json``, ``features/feature_{i:05d}.json``,
    ``tracker_state.json``."""

    def __init__(self, tracker: TopKTracker, output_dir: Path | str):
        self.tracker = tracker
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.interpretations: dict[int, FeatureInterpretation] = {}

    def generate_feature_report(
        self,
        feature_idx: int,
        include_audio_paths: bool = True,
        stats: dict | None = None,
    ) -> dict:
        examples = self.tracker.get_top_examples(feature_idx)
        # callers writing many reports pass the precomputed all-feature
        # stats once (get_feature_stats builds F dicts — per-call at
        # F=40960 that was the quadratic term in save_reports)
        stats = (stats or self.tracker.get_feature_stats())[feature_idx]
        report = {"feature_idx": feature_idx, "stats": stats, "top_examples": []}
        for ex in examples:
            ex_data = {
                "activation_value": ex.activation_value,
                "sample_idx": ex.sample_idx,
                "position_idx": ex.position_idx,
                "timestamp_ms": ex.timestamp_ms,
                "transcription": ex.transcription,
            }
            if include_audio_paths and ex.audio_path:
                ex_data["audio_path"] = ex.audio_path
            report["top_examples"].append(ex_data)
        if feature_idx in self.interpretations:
            report["interpretation"] = self.interpretations[feature_idx].to_dict()
        return report

    def generate_summary_report(self, top_n: int = 100, stats: dict | None = None) -> dict:
        stats = stats or self.tracker.get_feature_stats()
        sorted_features = sorted(
            stats.items(), key=lambda x: x[1]["max_activation"], reverse=True
        )[:top_n]
        return {
            "num_features": self.tracker.num_features,
            "samples_processed": self.tracker.samples_processed,
            "total_activations": self.tracker.total_activations,
            "top_features": [
                {"feature_idx": fi, **fs} for fi, fs in sorted_features
            ],
        }

    def save_reports(self, top_n: int = 100) -> None:
        stats = self.tracker.get_feature_stats()  # computed ONCE
        summary = self.generate_summary_report(top_n=top_n, stats=stats)
        with open(self.output_dir / "summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        features_dir = self.output_dir / "features"
        features_dir.mkdir(exist_ok=True)
        for feat in summary["top_features"]:
            fi = feat["feature_idx"]
            with open(features_dir / f"feature_{fi:05d}.json", "w") as f:
                json.dump(self.generate_feature_report(fi, stats=stats), f, indent=2)
        self.tracker.save(self.output_dir / "tracker_state.json")

    def add_interpretation(
        self,
        feature_idx: int,
        category: str,
        description: str,
        confidence: float = 0.5,
        evidence: list[str] | None = None,
    ) -> None:
        self.interpretations[feature_idx] = FeatureInterpretation(
            feature_idx=feature_idx,
            category=category,
            description=description,
            confidence=confidence,
            evidence=evidence or [],
        )


def collect_top_activations(
    model,
    dataloader,
    num_features: int,
    k: int = 20,
    device=None,
) -> TopKTracker:
    """Collect top-k activating examples.

    ``model`` is duck-typed: uses ``encode`` if present, else calls and
    reads ``.hidden``.  The tracker lives on ``device``, by default the
    model's (the card for a model without one).
    """
    if device is None:
        device = getattr(model, "device", None)
    tracker = TopKTracker(num_features=num_features, k=k, device=device)
    if hasattr(model, "eval"):
        model.eval()
    sample_idx = 0
    for batch in dataloader:
        if isinstance(batch, (tuple, list)):
            activations, metadata = batch[0], (batch[1] if len(batch) > 1 else None)
        else:
            activations, metadata = batch, None
        activations = torch.as_tensor(activations)
        with torch.no_grad():
            if hasattr(model, "encode"):
                hidden = model.encode(activations)
            else:
                out = model(activations)
                hidden = out.hidden if hasattr(out, "hidden") else out[1]
        b = hidden.shape[0]
        sample_indices = list(range(sample_idx, sample_idx + b))
        transcriptions = None
        if metadata is not None and isinstance(metadata, dict):
            transcriptions = metadata.get("transcriptions")
        tracker.update(hidden, sample_indices, transcriptions=transcriptions)
        sample_idx += b
    return tracker
