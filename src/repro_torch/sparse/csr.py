"""Minimal numpy CSR/CSC/ELL sparse utilities.

The port's own copy of ``repro.sparse.csr`` (which it may not import): the
same arrays from the same ``rng`` stream. Model weights and queries are
converted once, at load time, into static-shape ELL arrays; the tensors the
device sees are made from those.

Conventions
-----------
* ELL padding uses a *sentinel index* equal to the logical dimension size
  (one past the last valid index) and value 0.0. Dense lookup tables carry
  one extra trailing slot so gathers at the sentinel read 0.
* Index arrays are int32, values float32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed sparse row matrix (queries are stored this way, paper §4)."""

    indptr: np.ndarray   # [n + 1] int64
    indices: np.ndarray  # [nnz]   int32, sorted within each row
    data: np.ndarray     # [nnz]   float32
    shape: Tuple[int, int]

    @classmethod
    def from_dense(cls, x: np.ndarray) -> "CSR":
        n, d = x.shape
        indptr = np.zeros(n + 1, dtype=np.int64)
        idx_list, val_list = [], []
        for i in range(n):
            (nz,) = np.nonzero(x[i])
            idx_list.append(nz.astype(np.int32))
            val_list.append(x[i, nz].astype(np.float32))
            indptr[i + 1] = indptr[i] + len(nz)
        indices = np.concatenate(idx_list) if idx_list else np.zeros(0, np.int32)
        data = np.concatenate(val_list) if val_list else np.zeros(0, np.float32)
        return cls(indptr, indices, data, (n, d))

    @classmethod
    def from_rows(cls, rows_idx, rows_val, shape) -> "CSR":
        """Build from per-row (sorted) index/value arrays."""
        n = len(rows_idx)
        indptr = np.zeros(n + 1, dtype=np.int64)
        for i, r in enumerate(rows_idx):
            indptr[i + 1] = indptr[i] + len(r)
        indices = (np.concatenate(rows_idx) if n else np.zeros(0)).astype(np.int32)
        data = (np.concatenate(rows_val) if n else np.zeros(0)).astype(np.float32)
        return cls(indptr, indices, data, shape)

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def to_dense(self) -> np.ndarray:
        n, d = self.shape
        out = np.zeros((n, d), dtype=np.float32)
        for i in range(n):
            idx, val = self.row(i)
            out[i, idx] = val
        return out

    def to_ell(self, width: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """Pad rows to a common width: (idx [n, Q] int32 sentinel-padded with
        d, val [n, Q] f32 zero-padded). An explicit ``width`` truncates longer
        rows; ``None`` fits the longest row."""
        return rows_to_ell(self, np.arange(self.shape[0]), width)

    def slice_rows(self, sel: np.ndarray) -> "CSR":
        rows_i = [self.row(i)[0] for i in sel]
        rows_v = [self.row(i)[1] for i in sel]
        return CSR.from_rows(rows_i, rows_v, (len(sel), self.shape[1]))


def rows_to_ell(
    csr: CSR,
    rows: np.ndarray,
    width: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized CSR→ELL marshalling for an arbitrary row selection.

    Sentinel index ``d``, zero values, rows truncated at ``width`` — the
    serving engine's per-batch marshalling.
    """
    rows = np.asarray(rows, dtype=np.int64)
    n, d = len(rows), csr.shape[1]
    starts = csr.indptr[rows]
    nnz = csr.indptr[rows + 1] - starts
    q = int(width) if width is not None else int(nnz.max(initial=0))
    q = max(q, 1)
    if n == 0 or csr.indices.size == 0:
        return (np.full((n, q), d, np.int32), np.zeros((n, q), np.float32))
    offs = np.arange(q, dtype=np.int64)
    valid = offs[None, :] < np.minimum(nnz, q)[:, None]      # [n, q]
    src = np.where(valid, starts[:, None] + offs[None, :], 0)
    idx = np.where(valid, csr.indices[src], d).astype(np.int32)
    val = np.where(valid, csr.data[src], 0.0).astype(np.float32)
    return idx, val


def rows_to_ell_loop(
    csr: CSR,
    rows: np.ndarray,
    width: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row reference implementation of :func:`rows_to_ell` (test oracle)."""
    rows = np.asarray(rows, dtype=np.int64)
    n, d = len(rows), csr.shape[1]
    if width is not None:
        q = int(width)
    else:
        nnz = csr.indptr[rows + 1] - csr.indptr[rows]
        q = int(nnz.max(initial=0))
    q = max(q, 1)
    idx = np.full((n, q), d, dtype=np.int32)
    val = np.zeros((n, q), dtype=np.float32)
    for i, r in enumerate(rows):
        ri, rv = csr.row(int(r))
        k = min(len(ri), q)
        idx[i, :k] = ri[:k]
        val[i, :k] = rv[:k]
    return idx, val


@dataclasses.dataclass
class CSC:
    """Compressed sparse column matrix (ranker weights, paper §4)."""

    indptr: np.ndarray   # [ncols + 1]
    indices: np.ndarray  # [nnz] row indices, sorted within each column
    data: np.ndarray     # [nnz]
    shape: Tuple[int, int]  # (d, L)

    @classmethod
    def from_dense(cls, w: np.ndarray) -> "CSC":
        t = CSR.from_dense(np.ascontiguousarray(w.T))
        return cls(t.indptr, t.indices, t.data, (w.shape[0], w.shape[1]))

    @classmethod
    def from_cols(cls, cols_idx, cols_val, shape) -> "CSC":
        t = CSR.from_rows(cols_idx, cols_val, (shape[1], shape[0]))
        return cls(t.indptr, t.indices, t.data, shape)

    def col(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[j], self.indptr[j + 1]
        return self.indices[s:e], self.data[s:e]

    def col_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def to_dense(self) -> np.ndarray:
        d, L = self.shape
        out = np.zeros((d, L), dtype=np.float32)
        for j in range(L):
            idx, val = self.col(j)
            out[idx, j] = val
        return out

    def to_col_ell(self, width: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """Per-column ELL (the vanilla, unchunked layout): (rows [L, Rc]
        padded with sentinel=d, vals [L, Rc])."""
        d, L = self.shape
        rc = int(width) if width is not None else int(self.col_nnz().max(initial=0))
        rc = max(rc, 1)
        rows = np.full((L, rc), d, dtype=np.int32)
        vals = np.zeros((L, rc), dtype=np.float32)
        for j in range(L):
            ci, cv = self.col(j)
            rows[j, : len(ci)] = ci
            vals[j, : len(ci)] = cv
        return rows, vals


def random_sparse_csr(
    n: int,
    d: int,
    nnz_per_row: int,
    rng: np.random.Generator,
    *,
    zipf_a: float = 1.3,
    value_scale: float = 1.0,
) -> CSR:
    """Synthetic TFIDF-like sparse queries: Zipf-distributed feature ids."""
    rows_i, rows_v = [], []
    for _ in range(n):
        k = max(1, int(rng.poisson(nnz_per_row)))
        k = min(k, d)
        raw = (rng.zipf(zipf_a, size=3 * k + 8) - 1) % d
        idx = np.unique(raw)[:k].astype(np.int32)
        idx.sort()
        val = (rng.standard_normal(len(idx)).astype(np.float32)) * value_scale
        val = np.abs(val) + 0.05
        rows_i.append(idx)
        rows_v.append(val.astype(np.float32))
    return CSR.from_rows(rows_i, rows_v, (n, d))


def random_sparse_csc(
    d: int,
    L: int,
    nnz_per_col: int,
    rng: np.random.Generator,
    *,
    sibling_groups: int | None = None,
    sibling_overlap: float = 0.8,
) -> CSC:
    """Synthetic ranker weights with sibling support correlation (paper
    Item 2): columns come in groups of ``sibling_groups`` that share a
    support pool; each sibling keeps a ``sibling_overlap`` fraction of it
    plus private indices."""
    group = max(1, sibling_groups or 1)
    pool_size = min(d, max(1, int(nnz_per_col / max(sibling_overlap, 1e-3))))
    n_shared = int(round(nnz_per_col * sibling_overlap))
    n_priv = max(0, nnz_per_col - n_shared)

    cols_i, cols_v = [], []
    for g0 in range(0, L, group):
        gcols = min(group, L - g0)
        shared = rng.choice(d, size=pool_size, replace=False)
        keep = rng.random((gcols, pool_size)).argsort(axis=1)[:, :n_shared]
        take = shared[keep]                                   # [gcols, n_shared]
        priv = rng.integers(0, d, size=(gcols, n_priv)) if n_priv else None
        for j in range(gcols):
            parts = [take[j]] if n_shared else []
            if priv is not None:
                parts.append(priv[j])
            idx = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
            cols_i.append(idx.astype(np.int32))
            cols_v.append(rng.standard_normal(len(idx)).astype(np.float32))
    return CSC.from_cols(cols_i, cols_v, (d, L))
