"""Beam search over the label tree (paper Alg. 1, lines 5-9).

Counterpart of ``repro.core.beam``. Selection is canonical: candidates are
ordered by (score desc, child id asc), which the reference gets from a
two-key ``lax.sort``. ``torch.sort`` has one key, so :func:`_canonical_order`
packs both into one int64 per candidate: the high 32 bits order the negated
score, the low 32 bits the id. ``lax.sort`` treats -0.0 and +0.0 as equal
(the id breaks the tie), so the score key is taken from ``-score + 0.0``,
which folds -0.0 into +0.0.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # rounds to the reference's float32(-1e30) in an f32 tensor


def combine_scores(
    parent_scores: torch.Tensor,  # [n, b]  (prob or log-prob, see mode)
    logits: torch.Tensor,         # [n, b, B] ranker activations (pre-sigmoid)
    mode: str = "prod",
) -> torch.Tensor:
    """Conditional combine (paper eq. 5): child = σ(logit) ⊗ parent.

    ``prod`` works in probability space, ``logsum`` in log space; rankings
    are identical because log is monotone.
    """
    if mode == "prod":
        return torch.sigmoid(logits) * parent_scores[..., None]
    if mode == "logsum":
        return F.logsigmoid(logits) + parent_scores[..., None]
    raise ValueError(f"unknown score mode {mode}")


def _canonical_order(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-row permutation sorting by (score desc, id asc).

    ``ids`` must fit in int32 and be unique per row, as child and label ids
    are; the packed keys are then unique, so the order is total.
    """
    bits = ((-scores) + 0.0).contiguous().view(torch.int32).to(torch.int64)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # float order as signed ints
    packed = (key << 32) | (ids.to(torch.int64) + 2**31)
    return torch.argsort(packed, dim=-1)


def beam_select(
    parent_ids: torch.Tensor,  # int [n, b]
    scores: torch.Tensor,      # f32 [n, b, B] pre-combined child scores
    n_cols: int,               # valid columns at this level (masks padding)
    next_b: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SelectTop_b over pre-combined child scores (paper Alg. 1 line 9).

    Children ids are parent*B + within-chunk offset; phantom columns from
    chunk padding (id >= n_cols) are masked to ``NEG_INF``. Returns
    ``(ids int64 [n, next_b], scores [n, next_b])`` in canonical order.
    """
    n, b, B = scores.shape
    child_ids = (
        parent_ids.to(torch.int64)[:, :, None] * B
        + torch.arange(B, device=scores.device)
    ).reshape(n, b * B)
    flat = scores.reshape(n, b * B)
    flat = torch.where(child_ids < n_cols, flat, torch.full_like(flat, NEG_INF))
    top = _canonical_order(flat, child_ids)[:, :next_b]
    return child_ids.gather(1, top), flat.gather(1, top)


def topk_canonical(
    scores: torch.Tensor,  # f32 [n, m] candidate scores (NEG_INF = masked)
    ids: torch.Tensor,     # int [n, m] candidate ids, aligned with scores
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical top-k over flat candidate lists: (score desc, id asc).
    Returns ``(ids[:, :k], scores[:, :k])``."""
    top = _canonical_order(scores, ids)[:, :k]
    return ids.to(torch.int64).gather(1, top), scores.gather(1, top)


def beam_step(
    parent_ids: torch.Tensor,     # int [n, b]
    parent_scores: torch.Tensor,  # f32 [n, b]
    logits: torch.Tensor,         # f32 [n, b, B]
    n_cols: int,
    next_b: int,
    *,
    mode: str = "prod",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine (eq. 5) + canonical SelectTop_b (paper Alg. 1 lines 8-9)."""
    scores = combine_scores(parent_scores, logits, mode)
    return beam_select(parent_ids, scores, n_cols, next_b)
