"""Ranking metrics for XMR evaluation (precision@k / recall@k).

The port's own copy of ``repro.metrics``: plain Python over numpy labels,
so the same predictions give the same numbers in both packages. Beside them,
``repro_torch.quant.contract.recall_at_k`` is a different metric (recall of
one ranking against another), as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def precision_at_k(pred_labels: np.ndarray, true: Sequence[np.ndarray], k: int) -> float:
    """Mean P@k; pred_labels [n, >=k] (-1 entries = padding, never count)."""
    n = pred_labels.shape[0]
    hits = 0.0
    for i in range(n):
        t = set(int(x) for x in true[i])
        p = [int(x) for x in pred_labels[i, :k] if x >= 0]
        hits += sum(1 for x in p if x in t) / k
    return hits / max(n, 1)


def recall_at_k(pred_labels: np.ndarray, true: Sequence[np.ndarray], k: int) -> float:
    """Mean R@k over the queries; a query with no true labels adds 0."""
    n = pred_labels.shape[0]
    tot = 0.0
    for i in range(n):
        t = set(int(x) for x in true[i])
        if not t:
            continue
        p = [int(x) for x in pred_labels[i, :k] if x >= 0]
        tot += sum(1 for x in p if x in t) / len(t)
    return tot / max(n, 1)
