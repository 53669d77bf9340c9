"""Oracles for the MSCM kernels (counterpart of ``repro.kernels.ref``).

``mscm_ref`` is the dense-algebra ground truth: rebuild W from the chunk
tiles, take the full product X·W, and read out the masked blocks.
``block_ref_marching`` is a numpy marching-pointer version of the paper's
Algorithm 2, an independent scalar oracle.
"""

from __future__ import annotations

import numpy as np
import torch


def mscm_ref(
    x_dense: torch.Tensor,   # f32 [n, d+1] (dense queries incl. sentinel slot)
    rows: torch.Tensor,      # int [C, R] sentinel-padded
    vals: torch.Tensor,      # f32 [C, R, B]
    block_q: torch.Tensor,   # int [A]
    block_c: torch.Tensor,   # int [A]
) -> torch.Tensor:
    """Dense oracle: A[a] = (x[block_q[a]] · W)[block_c[a]·B : +B]."""
    c, r, b = vals.shape
    d_plus = x_dense.shape[1]
    dev = vals.device
    w = torch.zeros((d_plus, c * b), dtype=vals.dtype, device=dev)
    col_ids = torch.arange(c, device=dev)[:, None, None] * b + torch.arange(b, device=dev)
    col_ids = col_ids.expand(c, r, b)
    row_ids = rows.to(torch.int64)[:, :, None].expand(c, r, b)
    w.index_put_((row_ids.reshape(-1), col_ids.reshape(-1)), vals.reshape(-1), accumulate=True)
    w[d_plus - 1, :] = 0.0  # sentinel row carries no weight
    full = x_dense @ w                                                  # [n, C*B]
    cols = block_c.to(torch.int64)[:, None] * b + torch.arange(b, device=dev)  # [A, B]
    return full[block_q.to(torch.int64)[:, None], cols]


def block_ref_marching(
    x_idx: np.ndarray,       # int32 [nnz_x] sorted query support
    x_val: np.ndarray,       # f32 [nnz_x]
    chunk_rows: np.ndarray,  # int32 [R] sentinel-padded, sorted
    chunk_vals: np.ndarray,  # f32 [R, B]
    d: int,
) -> np.ndarray:
    """Paper Algorithm 2 with the marching-pointer iterator (numpy scalar)."""
    b = chunk_vals.shape[1]
    z = np.zeros(b, dtype=np.float64)
    ix, ik = 0, 0
    nx, nk = len(x_idx), len(chunk_rows)
    while ix < nx and ik < nk:
        jx, jk = int(x_idx[ix]), int(chunk_rows[ik])
        if jx >= d or jk >= d:
            break
        if jx == jk:
            z += float(x_val[ix]) * chunk_vals[ik].astype(np.float64)
            ix += 1
            ik += 1
        elif jx < jk:
            ix += 1
        else:
            ik += 1
    return z.astype(np.float32)
