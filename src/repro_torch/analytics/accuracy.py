"""Port of ``repro/analytics/accuracy.py``, verbatim.

F1 accuracy (paper §2.1): harmonic mean of precision and recall of an
operator's item set against ground truth = the same operator's items on
full-fidelity video (paper §6.1 methodology)."""

from __future__ import annotations


def f1_score(pred: set, truth: set) -> float:
    if not truth and not pred:
        return 1.0
    tp = len(pred & truth)
    precision = tp / len(pred) if pred else 0.0
    recall = tp / len(truth) if truth else 0.0
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)
