"""Heuristic feature auto-labeling from top-example transcriptions (a copy
of ``whisper_sae_tpu/analysis/auto_label.py`` over the port's tracker).

For each tracked feature, scores the words of its top examples'
transcriptions against the corpus baseline (add-one-smoothed relative
frequency ratio — a tf-idf-style distinctiveness score) and proposes the
most distinctive words as a label.  Confidence reflects how concentrated
the evidence is (fraction of the feature's examples containing the top
word).

This is the cheap, offline first pass of the reference workflow's
"listen and label" loop: labels land as standard
:class:`FeatureInterpretation` entries (category "auto/lexical"), so
``FeatureReport.save_reports`` and the dashboard surface them unchanged
and a human pass can overwrite them.
"""

from __future__ import annotations

from collections import Counter

from .feature_viz import FeatureReport, TopKTracker


def _words(text: str) -> list[str]:
    cleaned = [c.lower() if (c.isalnum() or c == "'") else " " for c in text]
    return "".join(cleaned).split()


def auto_label_features(
    tracker: TopKTracker,
    report: FeatureReport,
    feature_indices: list[int] | None = None,
    top_words: int = 3,
    min_examples: int = 3,
) -> dict[int, list[str]]:
    """Attach lexical auto-labels to ``report`` for the given features.

    Returns {feature_idx: [distinctive words]} for the labeled features
    (features with fewer than ``min_examples`` transcribed examples are
    skipped).
    """
    if feature_indices is None:
        feature_indices = list(range(tracker.num_features))

    # corpus baseline over every transcription the tracker holds
    corpus = Counter()
    per_feature: dict[int, list[list[str]]] = {}
    for fi in feature_indices:
        docs = []
        for ex in tracker.get_top_examples(fi):
            if ex.transcription:
                docs.append(_words(ex.transcription))
        per_feature[fi] = docs
        for d in docs:
            corpus.update(set(d))
    total_docs = max(sum(len(d) for d in per_feature.values()), 1)

    labels: dict[int, list[str]] = {}
    for fi, docs in per_feature.items():
        if len(docs) < min_examples:
            continue
        present = Counter()
        for d in docs:
            present.update(set(d))
        scored = []
        for w, n in present.items():
            if len(w) < 2:
                continue
            feat_rate = n / len(docs)
            corpus_rate = (corpus[w] + 1) / (total_docs + 1)
            scored.append((feat_rate / corpus_rate, feat_rate, w))
        if not scored:
            continue
        scored.sort(reverse=True)
        words = [w for _, _, w in scored[:top_words]]
        confidence = scored[0][1]  # fraction of examples with the top word
        labels[fi] = words
        report.add_interpretation(
            fi,
            category="auto/lexical",
            description="distinctive words: " + ", ".join(words),
            confidence=round(float(confidence), 3),
            evidence=[" ".join(d)[:80] for d in docs[:3]],
        )
    return labels
