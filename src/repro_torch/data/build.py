"""Random benchmark models at a dataset's dimensions.

Counterpart of ``benchmarks/common.py::build_benchmark_tree`` (which imports
jax): latency depends only on the sparsity structure, not on learned
values, so the model is random at the real sparsity, made from ``rng``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import XMRTree
from repro_torch.data.xmr_data import XMRShape
from repro_torch.sparse.csr import random_sparse_csc
from repro_torch.trees.cluster import build_tree_structure


def build_benchmark_tree(
    shape: XMRShape,
    branching: int,
    rng: np.random.Generator,
    *,
    upper_nnz: int = 64,
    sibling_overlap: float = 0.8,
    device: str | torch.device | None = None,
) -> XMRTree:
    """Random model at the shape's dimensions: a perfect ``branching``-ary
    tree whose leaf columns hold ``shape.col_nnz`` nonzeros and upper columns
    ``upper_nnz``. Same arrays as the reference for the same ``rng``."""
    struct = build_tree_structure(shape.L, branching)
    weights = []
    for size in struct.level_sizes:
        nnz = shape.col_nnz if size == struct.level_sizes[-1] else upper_nnz
        weights.append(
            random_sparse_csc(shape.d, size, nnz, rng,
                              sibling_groups=branching,
                              sibling_overlap=sibling_overlap)
        )
    return XMRTree.from_weight_matrices(weights, branching, device=device)
