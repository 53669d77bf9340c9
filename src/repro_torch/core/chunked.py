"""Column-chunked weight matrices — the MSCM data structure (paper §4, eq. 7-8).

The port's own copy of ``repro.core.chunked`` (numpy; it builds the same
arrays). A *chunk* is the group of ``B`` sibling columns of a level's weight
matrix ``W ∈ R^{d×L}`` that share a parent node; it is stored as an ELL tile:

    rows : int32 [C, R]      union of the sibling row supports, sorted and
                             padded with the sentinel ``d``
    vals : f32   [C, R, B]   dense (R × B) value tile per chunk; positions
                             where a sibling lacks an entry hold explicit 0
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSC


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class ChunkedLayer:
    """One tree level's weight matrix in chunked (MSCM) format."""

    rows: np.ndarray  # int32 [C, R], sentinel-padded (sentinel == d)
    vals: np.ndarray  # f32   [C, R, B]
    d: int            # feature dimension
    B: int            # branching factor == columns per chunk

    @property
    def C(self) -> int:
        return self.rows.shape[0]

    @property
    def R(self) -> int:
        return self.rows.shape[1]

    @property
    def n_cols(self) -> int:
        return self.C * self.B

    @property
    def nnz_dense_tile(self) -> int:
        """Elements stored (explicit zeros included): the memory model."""
        return int(self.vals.size)

    @classmethod
    def from_csc(
        cls,
        w: CSC,
        branching: int,
        *,
        row_align: int = 8,
        min_width: int = 8,
    ) -> "ChunkedLayer":
        """Columns [i*B, (i+1)*B) form chunk i; the last chunk is zero-padded
        if L % B != 0. R is the largest union support over the chunks,
        rounded up to ``row_align``."""
        d, L = w.shape
        B = int(branching)
        C = (L + B - 1) // B
        unions = []
        width = min_width
        col_start = w.indptr
        for c in range(C):
            lo = col_start[c * B]
            hi = col_start[min((c + 1) * B, L)]
            idx = np.unique(w.indices[lo:hi])
            unions.append(idx.astype(np.int32))
            width = max(width, len(idx))
        R = _round_up(width, row_align)
        rows = np.full((C, R), d, dtype=np.int32)
        vals = np.zeros((C, R, B), dtype=np.float32)
        for c, idx in enumerate(unions):
            rows[c, : len(idx)] = idx
            lo = col_start[c * B]
            hi = col_start[min((c + 1) * B, L)]
            ent_rows = w.indices[lo:hi]
            ent_vals = w.data[lo:hi]
            n_cols = min((c + 1) * B, L) - c * B
            reps = np.diff(col_start[c * B : c * B + n_cols + 1]).astype(np.int64)
            ent_cols = np.repeat(np.arange(n_cols), reps)
            pos = np.searchsorted(idx, ent_rows)
            vals[c, pos, ent_cols] = ent_vals
        return cls(rows=rows, vals=vals, d=d, B=B)

    def to_dense(self) -> np.ndarray:
        """Reconstruct the dense [d, C*B] weight matrix (tests only)."""
        out = np.zeros((self.d + 1, self.n_cols), dtype=np.float32)
        for c in range(self.C):
            cols = slice(c * self.B, (c + 1) * self.B)
            np.add.at(out, (self.rows[c], cols), self.vals[c])
        return out[: self.d]

    def memory_bytes(self) -> int:
        return self.rows.nbytes + self.vals.nbytes

    def occupancy(self) -> float:
        """Share of the [C, R, B] tile holding true nonzeros (paper item 2)."""
        return float((self.vals != 0).mean())


@dataclasses.dataclass
class ColumnELLLayer:
    """Vanilla per-column layout (the paper's non-MSCM baseline, Alg. 4)."""

    rows: np.ndarray  # int32 [L, Rc], sentinel-padded
    vals: np.ndarray  # f32   [L, Rc]
    d: int
    B: int            # branching factor (for block -> column expansion)

    @property
    def L(self) -> int:
        return self.rows.shape[0]

    @property
    def Rc(self) -> int:
        return self.rows.shape[1]

    @classmethod
    def from_csc(cls, w: CSC, branching: int, *, row_align: int = 8) -> "ColumnELLLayer":
        d, L = w.shape
        width = _round_up(max(1, int(w.col_nnz().max(initial=1))), row_align)
        rows, vals = w.to_col_ell(width)
        B = int(branching)
        Lp = _round_up(L, B)
        if Lp != L:  # pad phantom columns so chunk c covers cols [cB, cB+B)
            rows = np.concatenate([rows, np.full((Lp - L, width), d, np.int32)])
            vals = np.concatenate([vals, np.zeros((Lp - L, width), np.float32)])
        return cls(rows=rows, vals=vals, d=d, B=B)

    def memory_bytes(self) -> int:
        return self.rows.nbytes + self.vals.nbytes
