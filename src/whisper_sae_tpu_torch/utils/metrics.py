"""Word error rate for ASR validation (no external dependencies).

The port's own copy of ``whisper_sae_tpu/utils/metrics.py``: the same
normalisation and word-level edit distance.
"""

from __future__ import annotations


def _edit_distance(ref: list[str], hyp: list[str]) -> int:
    """Word-level Levenshtein distance, O(len(ref)) memory."""
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        cur = [i]
        for j, h in enumerate(hyp, start=1):
            cur.append(min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (r != h),  # substitution / match
            ))
        prev = cur
    return prev[-1]


def _normalize(text: str) -> list[str]:
    """Lower-case, strip punctuation to bare words (LibriSpeech refs are
    upper-case unpunctuated; Whisper emits cased punctuated text)."""
    cleaned = [
        c.lower() if (c.isalnum() or c == "'") else " " for c in text
    ]
    return "".join(cleaned).split()


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate of ``hypothesis`` against ``reference`` after
    case/punctuation normalization.  Empty reference: 0.0 when the
    hypothesis is empty too, else 1.0."""
    ref = _normalize(reference)
    hyp = _normalize(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def corpus_wer(pairs: list[tuple[str, str]]) -> float:
    """Corpus-level WER: total edits over total reference words."""
    edits = words = 0
    for reference, hypothesis in pairs:
        ref = _normalize(reference)
        hyp = _normalize(hypothesis)
        edits += _edit_distance(ref, hyp) if ref else len(hyp)
        words += len(ref)
    if words == 0:
        return 0.0 if edits == 0 else 1.0
    return edits / words
