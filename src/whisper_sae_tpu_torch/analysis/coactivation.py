"""Feature co-activation: which latents fire together (counterpart of
``whisper_sae_tpu/analysis/coactivation.py``).

Streams the activation cache through a trained coder's encoder a second
time (the tracker pass's batching) and accumulates, for a chosen feature
subset, the ``[M, M]`` co-occurrence counts on the hidden's device: one
``act.T @ act`` on 0/1 f32 per batch (exact below 2**24 rows a batch; run
as a true f32 product all the same), nothing quadratic in the full
feature count F.  Pairs are scored by Jaccard overlap |A∩B| / |A∪B|.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..utils.device import f32_matmuls


def _accumulate(counts: torch.Tensor, hidden_sub: torch.Tensor) -> torch.Tensor:
    """counts [M, M] += (hidden_sub > 0)^T (hidden_sub > 0)."""
    act = (hidden_sub > 0.0).to(torch.float32)
    with f32_matmuls():
        return counts + act.t() @ act


def compute_coactivation(
    encode_chunk,
    num_samples: int,
    batch_samples: int,
    feature_indices: list[int],
    top_pairs: int = 50,
) -> dict:
    """Co-occurrence statistics for ``feature_indices``.

    Args:
        encode_chunk: (lo, hi) -> [rows, F] hidden activations (the
            analyze job's streaming encoder).
        num_samples / batch_samples: the same batching as the tracker
            pass (host memory stays bounded).
        feature_indices: subset of features (typically the report's top
            features).
        top_pairs: how many highest-Jaccard pairs to return.

    Returns a JSON-ready dict: per-feature firing rates and the top
    co-activating pairs with counts and Jaccard scores.
    """
    feats = sorted(set(int(i) for i in feature_indices))
    m = len(feats)
    counts, idx = None, None
    total_rows = 0
    for lo in range(0, num_samples, batch_samples):
        hi = min(lo + batch_samples, num_samples)
        hidden = torch.as_tensor(encode_chunk(lo, hi))
        if counts is None:
            counts = torch.zeros((m, m), dtype=torch.float32, device=hidden.device)
            idx = torch.tensor(feats, dtype=torch.int64, device=hidden.device)
        # a column gather of the M tracked features (M is small: the
        # report's top features)
        counts = _accumulate(counts, hidden[:, idx])
        total_rows += int(hidden.shape[0])
    counts = counts.cpu().numpy() if counts is not None else np.zeros((m, m), np.float32)
    solo = np.diag(counts)

    pairs = []
    for a in range(m):
        for b in range(a + 1, m):
            inter = counts[a, b]
            union = solo[a] + solo[b] - inter
            if inter > 0 and union > 0:
                pairs.append((
                    float(inter / union), int(inter), feats[a], feats[b]
                ))
    pairs.sort(reverse=True)
    return {
        "num_tokens": total_rows,
        "features": feats,
        "firing_rate": {
            str(f): round(float(solo[i] / max(total_rows, 1)), 6)
            for i, f in enumerate(feats)
        },
        "top_pairs": [
            {
                "feature_a": fa,
                "feature_b": fb,
                "jaccard": round(j, 5),
                "co_count": c,
            }
            for j, c, fa, fb in pairs[:top_pairs]
        ],
    }


def save_coactivation(result: dict, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=2))
    return path
