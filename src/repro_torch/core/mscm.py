"""Masked Sparse Chunk Multiplication — PyTorch versions (paper §4).

Counterpart of ``repro.core.mscm``. Evaluates the masked product
A = M ⊙ (X · W) where the mask nonzeros come in width-B blocks, one per
(query, surviving-parent) beam pair, given as parallel index vectors

    block_q : int [A]   query row of each block
    block_c : int [A]   chunk (parent) id of each block

and returns the dense [A, B] stack of block values.

JAX clamps an out-of-range gather index to the last valid one; PyTorch
raises (CPU) or faults (CUDA). Where a chunk id can point past the last
chunk (a beam that kept masked children on a ragged tree), the functions
here clamp it explicitly, to the same result as the reference.
"""

from __future__ import annotations

import torch


def scatter_dense(x_idx: torch.Tensor, x_val: torch.Tensor, d: int) -> torch.Tensor:
    """Scatter ELL queries into a dense [n, d+1] lookup table.

    The trailing slot (index d) is the sentinel target: ELL padding carries
    the value 0 there, so it stays 0 and gathers at padded chunk rows add
    nothing. Indices outside [0, d] are dropped (the reference's
    ``mode="drop"`` drops those past d; query ids are never negative).
    """
    n = x_idx.shape[0]
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
    """Dense-lookup MSCM: gather query values at chunk rows, contract."""
    bc = block_c.clamp(0, rows.shape[0] - 1)
    xg = x_dense[block_q[:, None], rows[bc]]                   # [A, R]
    return torch.einsum("ar,arb->ab", xg, vals[bc])            # [A, B]


def gather_query_rows(
    x_dense: torch.Tensor, rows: torch.Tensor, block_q: torch.Tensor,
    block_c: torch.Tensor,
) -> torch.Tensor:
    """The gather half of dense-lookup MSCM: x_dense[q, rows[c]] -> [A, R]."""
    bc = block_c.clamp(0, rows.shape[0] - 1)
    return x_dense[block_q[:, None], rows[bc]]
