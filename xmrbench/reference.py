"""The plain reference: beam search over the benchmark's tree, from its
definition (the paper's Algorithm 1), in float64.

It imports nothing of the program and uses none of its kernels, plain
versions or oracles. It reads the generator's tensors and the queries as
ids and values, and looks each chunk row up in the query by binary search
(no dense table). At each level a query's candidates are the children of
its beam's chunks, scored σ(logit) × parent score, columns past the level's
true count left out; the next beam is the best ``min(beam, n_cols)`` by
(score desc, id asc), the best ``min(topk, n_cols)`` at the last level.

A level may hold only a range of its chunks (a ``held`` attribute, ``(c0,
c1)``: its chunk ``i`` is global chunk ``c0 + i``), as one chip's share of
a label-partitioned tree does at its last level. There the candidates are
the children of the beam's held chunks only; a slot that no held candidate
fills scores -inf.

``value_dtype`` rounds the tiles and query values to a lower precision and
computes in float32: the control.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _query_values(q_ids: torch.Tensor, q_vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[j, rows[j, ...]]`` for sorted, distinct ``q_ids[j]``: 0 where the
    query has no such id."""
    flat = rows.reshape(rows.shape[0], -1).to(torch.int64)
    pos = torch.searchsorted(q_ids, flat).clamp(max=q_ids.shape[1] - 1)
    hit = q_ids.gather(1, pos) == flat
    return torch.where(hit, q_vals.gather(1, pos), 0).reshape(rows.shape)


def _prep(q_ids, q_vals, value_dtype):
    if value_dtype is None:
        return q_ids.to(torch.int64), q_vals.to(torch.float64), torch.float64
    return q_ids.to(torch.int64), q_vals.to(value_dtype).to(torch.float32), torch.float32


def _tile(vals: torch.Tensor, value_dtype, dtype) -> torch.Tensor:
    if value_dtype is not None:
        vals = vals.to(value_dtype)
    return vals.to(dtype)


def _held(lev) -> Tuple[int, int]:
    return getattr(lev, "held", None) or (0, lev.chunk_rows.shape[0])


def _local(lev, chunks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(held mask, local chunk index clamped into the held range)."""
    c0, c1 = _held(lev)
    held = (chunks >= c0) & (chunks < c1)
    return held, torch.where(held, chunks - c0, 0)


def _canonical_top(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The best ``k`` of each row by (score desc, id asc)."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    ids, scores = ids.gather(1, by_id), scores.gather(1, by_id)
    by_score = torch.argsort(scores, dim=1, descending=True, stable=True)[:, :k]
    return scores.gather(1, by_score), ids.gather(1, by_score)


def search(levels: Sequence, n_cols: Sequence[int], branching: Sequence[int],
           q_ids: torch.Tensor, q_vals: torch.Tensor, *, beam: int, topk: int,
           value_dtype: Optional[torch.dtype] = None, block: int = 64,
           visits: Optional[List[List[torch.Tensor]]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` (scores, labels) of each query, ``[n, k]``. ``levels``
    holds each level's ``chunk_rows [C, R]`` and ``chunk_vals [C, R, B]``
    (as attributes); ``q_ids`` / ``q_vals`` are ``[n, Q]`` on their device.
    With ``visits`` (a list of one list a level), each level's visited held
    chunks, global ids ``[n, p]`` (-1 where not held), are appended there."""
    out_s, out_l = [], []
    for j0 in range(0, q_ids.shape[0], block):
        qi, qv, dtype = _prep(q_ids[j0:j0 + block], q_vals[j0:j0 + block], value_dtype)
        n = qi.shape[0]
        parents = torch.zeros((n, 1), dtype=torch.int64, device=qi.device)
        scores = torch.ones((n, 1), dtype=dtype, device=qi.device)
        for li, lev in enumerate(levels):
            b = branching[li]
            held, local = _local(lev, parents)                          # [n, p]
            if visits is not None:
                visits[li].append(torch.where(held, parents, -1))
            rows = lev.chunk_rows[local]                                # [n, p, R]
            w = _tile(lev.chunk_vals[local], value_dtype, dtype)        # [n, p, R, B]
            x = _query_values(qi, qv, rows).to(dtype)                   # [n, p, R]
            logits = torch.einsum("npr,nprb->npb", x, w)
            child = scores[..., None] * torch.sigmoid(logits)
            child = torch.where(held[..., None], child, -torch.inf).reshape(n, -1)
            ids = (parents[..., None] * b + torch.arange(b, device=qi.device)).reshape(n, -1)
            child = torch.where(ids < n_cols[li], child, -torch.inf)
            last = li == len(levels) - 1
            keep = min(topk if last else beam, n_cols[li])
            scores, parents = _canonical_top(child, ids, keep)
        out_s.append(scores)
        out_l.append(parents)
    return torch.cat(out_s), torch.cat(out_l)


def path_scores(levels: Sequence, branching: Sequence[int], q_ids: torch.Tensor,
                q_vals: torch.Tensor, labels: torch.Tensor, *, block: int = 64) -> torch.Tensor:
    """The score of each ``labels[j, i]`` for query ``j``, float64: the
    product of σ(logit) over the label and its ancestors, whatever the beam
    kept; NaN for a label whose chunk is not held."""
    out = []
    for j0 in range(0, q_ids.shape[0], block):
        qi, qv, dtype = _prep(q_ids[j0:j0 + block], q_vals[j0:j0 + block], None)
        node = labels[j0:j0 + block].to(torch.int64)                   # [n, k]
        score = torch.ones(node.shape, dtype=dtype, device=node.device)
        for li in reversed(range(len(levels))):
            b = branching[li]
            chunk, col = node // b, node % b
            lev = levels[li]
            held, local = _local(lev, chunk)
            rows = lev.chunk_rows[local]                                # [n, k, R]
            r = torch.arange(rows.shape[-1], device=node.device)
            w = lev.chunk_vals[local[..., None], r, col[..., None]]     # [n, k, R]
            x = _query_values(qi, qv, rows).to(dtype)
            score = score * torch.sigmoid((x * w.to(dtype)).sum(-1))
            score = torch.where(held, score, torch.nan)
            node = chunk
        out.append(score)
    return torch.cat(out)
