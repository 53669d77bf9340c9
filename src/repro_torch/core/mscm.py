"""Masked Sparse Chunk Multiplication — PyTorch versions (paper §4).

Counterpart of ``repro.core.mscm``. Evaluates the masked product
A = M ⊙ (X · W) where the mask nonzeros come in width-B blocks, one per
(query, surviving-parent) beam pair, given as parallel index vectors

    block_q : int [A]   query row of each block
    block_c : int [A]   chunk (parent) id of each block

and returns the dense [A, B] stack of block values. Three iterators, as in
the reference: ``mscm_dense_lookup`` (a dense [n, d+1] query table, one
gather per chunk), ``mscm_searchsorted`` (binary search of the chunk rows
in the query's sorted nonzeros, no table) and ``vanilla_columns`` (the
non-MSCM baseline: every column intersects the query on its own).

JAX clamps an out-of-range gather index to the last valid one; PyTorch
raises (CPU) or faults (CUDA). Where a chunk id can point past the last
chunk (a beam that kept masked children on a ragged tree), the functions
here clamp it explicitly, to the same result as the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import obs


def scatter_dense(x_idx: torch.Tensor, x_val: torch.Tensor, d: int) -> torch.Tensor:
    """Scatter ELL queries into a dense [n, d+1] lookup table.

    The trailing slot (index d) is the sentinel target: ELL padding carries
    the value 0 there, so it stays 0 and gathers at padded chunk rows add
    nothing. Indices outside [0, d] are dropped (the reference's
    ``mode="drop"`` drops those past d; query ids are never negative).
    """
    n = x_idx.shape[0]
    with obs.span("mscm.table", device=x_val.device):
        keep = (x_idx >= 0) & (x_idx <= d)
        idx = torch.where(keep, x_idx, d).to(torch.int64)
        val = torch.where(keep, x_val, 0.0)
        out = torch.zeros((n, d + 1), dtype=x_val.dtype, device=x_val.device)
        return out.scatter_add_(1, idx, val)


def mscm_dense_lookup(
    x_dense: torch.Tensor,   # f32 [n, d+1]
    rows: torch.Tensor,      # int [C, R]
    vals: torch.Tensor,      # f32 [C, R, B]
    block_q: torch.Tensor,   # int [A]
    block_c: torch.Tensor,   # int [A]
) -> torch.Tensor:
    """Dense-lookup MSCM: gather query values at chunk rows, contract.

    ``vals`` may be stored narrower than the table (bf16): the gathered
    blocks are cast, never the whole tensor, which gives the bits the
    reference's cast-then-gather gives without a copy of every chunk."""
    bc = block_c.clamp(0, rows.shape[0] - 1)
    xg = x_dense[block_q[:, None], rows[bc]]                   # [A, R]
    return torch.einsum("ar,arb->ab", xg, vals[bc].to(xg.dtype))   # [A, B]


def gather_query_rows(
    x_dense: torch.Tensor, rows: torch.Tensor, block_q: torch.Tensor,
    block_c: torch.Tensor,
) -> torch.Tensor:
    """The gather half of dense-lookup MSCM: x_dense[q, rows[c]] -> [A, R]."""
    bc = block_c.clamp(0, rows.shape[0] - 1)
    return x_dense[block_q[:, None], rows[bc]]


def _searchsorted_rows(xi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Row-wise searchsorted: for each a, positions of r[a, :] in xi[a, :].
    Both go to int64, since torch needs the two dtypes equal."""
    return torch.searchsorted(xi.to(torch.int64), r.to(torch.int64), side="left")


def _query_rows(x_idx, x_val, block_q):
    """The ELL rows of each block's query, with the query id clamped as the
    reference's gather clamps it."""
    bq = block_q.clamp(0, x_idx.shape[0] - 1)
    return x_idx[bq].to(torch.int64), x_val[bq]


def mscm_searchsorted(
    x_idx: torch.Tensor,     # int [n, Q] sorted, sentinel-padded (== d)
    x_val: torch.Tensor,     # f32 [n, Q]
    rows: torch.Tensor,      # int [C, R]
    vals: torch.Tensor,      # f32 [C, R, B]
    block_q: torch.Tensor,   # int [A]
    block_c: torch.Tensor,   # int [A]
    d: int,
) -> torch.Tensor:
    """Binary-search MSCM: intersect the chunk rows with the query's
    nonzeros, one searchsorted per chunk row (once per chunk, not per
    column)."""
    xi, xv = _query_rows(x_idx, x_val, block_q)      # [A, Q]
    bc = block_c.clamp(0, rows.shape[0] - 1)
    r = rows[bc].to(torch.int64)                     # [A, R]
    pos = _searchsorted_rows(xi, r).clamp(max=xi.shape[1] - 1)
    hit = (xi.gather(1, pos) == r) & (r < d)
    xg = torch.where(hit, xv.gather(1, pos), 0.0)
    return torch.einsum("ar,arb->ab", xg, vals[bc])


def vanilla_columns(
    x_idx: torch.Tensor,     # int [n, Q] sorted, sentinel-padded
    x_val: torch.Tensor,     # f32 [n, Q]
    col_rows: torch.Tensor,  # int [L, Rc] per-column ELL
    col_vals: torch.Tensor,  # f32 [L, Rc]
    block_q: torch.Tensor,   # int [A]
    block_c: torch.Tensor,   # int [A]
    branching: int,
    d: int,
) -> torch.Tensor:
    """Non-MSCM baseline (paper Alg. 4): each of a block's B columns is
    intersected with the query on its own, B traversals per block. Columns
    past the last stored one (the children of a phantom beam entry) are
    clamped, as the reference's gather clamps them."""
    a = block_q.shape[0]
    xi, xv = _query_rows(x_idx, x_val, block_q)      # [A, Q]
    cols = block_c.to(torch.int64)[:, None] * branching + torch.arange(
        branching, device=block_c.device)
    cols = cols.clamp(0, col_rows.shape[0] - 1)      # [A, B]
    cr = col_rows[cols].to(torch.int64).reshape(a, -1)  # [A, B*Rc]
    cv = col_vals[cols].reshape(a, -1)
    pos = _searchsorted_rows(xi, cr).clamp(max=xi.shape[1] - 1)
    hit = (xi.gather(1, pos) == cr) & (cr < d)
    terms = torch.where(hit, xv.gather(1, pos) * cv, 0.0)
    return terms.reshape(a, branching, -1).sum(-1)   # [A, B]


# ---------------------------------------------------------------------------
# Cost model counters (paper Table 6): host-side, for tests and benchmarks.
# ---------------------------------------------------------------------------

def iterator_cost(
    method: str,
    nnz_x: int,
    nnz_k: int,
    *,
    n_queries: int = 1,
    d: int = 0,
    hash_cost: float = 1.5,
) -> float:
    """Per-query traversal cost of one (query, chunk) intersection, after
    paper Table 6: marching O(nnz_x + nnz_K), binary search
    O(min · log max), hash O(h · nnz_x), dense O(nnz_K + nnz_x / n)."""
    if method == "marching":
        return nnz_x + nnz_k
    if method in ("binsearch", "searchsorted"):
        lo, hi = sorted((max(nnz_x, 1), max(nnz_k, 1)))
        return lo * float(np.log2(max(hi, 2)))
    if method == "hash":
        return hash_cost * nnz_x
    if method in ("dense", "dense_lookup"):
        return nnz_k + nnz_x / max(n_queries, 1)
    raise ValueError(f"unknown iterator {method}")


def chunk_vs_column_traversals(
    chunk_R: int, col_nnz: np.ndarray, branching: int
) -> Tuple[int, int]:
    """(MSCM traversal length, vanilla traversal length) for one block:
    once per chunk against once per column (paper items 1 and 2)."""
    return int(chunk_R), int(col_nnz[:branching].sum())
