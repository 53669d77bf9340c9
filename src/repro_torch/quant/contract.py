"""The quantized tier's measured accuracy contract (counterpart of
``repro.quant.contract``): recall@k against the f32 ranking and the top-k
score MAE, the two numbers a compressed tier reports in place of a bitwise
claim."""

from __future__ import annotations

import numpy as np
import torch


def topk_scores(scores, k: int) -> torch.Tensor:
    """Descending top-``k`` score values per row (values only, no ids): the
    contract compares score multisets, not a serving-path selection."""
    return torch.topk(torch.as_tensor(scores, dtype=torch.float32), k, dim=-1).values


def recall_at_k(ref_labels, got_labels) -> float:
    """Mean per-query overlap |ref ∩ got| / k between two top-k label sets,
    at the reference width k."""
    ref = np.asarray(ref_labels)
    got = np.asarray(got_labels)
    n, k = ref.shape
    hits = sum(np.intersect1d(ref[i], got[i]).size for i in range(n))
    return hits / float(n * k)


def score_mae(ref_scores, got_scores, k: int | None = None) -> float:
    """Mean |Δ| between the two tiers' descending top-k score values."""
    ref = np.asarray(ref_scores)
    got = np.asarray(got_scores)
    k = min(ref.shape[1], got.shape[1]) if k is None else k
    a = topk_scores(ref, k).numpy()
    b = topk_scores(got, k).numpy()
    return float(np.mean(np.abs(a - b)))
