"""XMR dataset shapes and benchmark queries.

The port's own copy of the benchmark half of ``repro.data.xmr_data``
(numpy): inference latency depends only on the sparsity structure (d, L,
nnz, branching, sibling overlap), so benchmark models are random at the
paper's true dimensions. The labeled generative dataset and the SVMlight
loader belong to the training path and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.sparse.csr import CSR, random_sparse_csr


@dataclasses.dataclass(frozen=True)
class XMRShape:
    name: str
    d: int           # feature dimension
    L: int           # labels
    n_test: int      # queries used for benchmarking
    query_nnz: int   # avg nonzeros per query
    col_nnz: int     # avg nonzeros per ranker column after pruning


# Paper Table 5 shapes with typical sparsity statistics.
PAPER_SHAPES: Dict[str, XMRShape] = {
    "eurlex-4k":     XMRShape("eurlex-4k",     5_000,     3_956,   3_865, 236, 64),
    "amazoncat-13k": XMRShape("amazoncat-13k", 203_882,   13_330,  306_782, 71, 64),
    "wiki10-31k":    XMRShape("wiki10-31k",    101_938,   30_938,  6_616, 673, 64),
    "wiki-500k":     XMRShape("wiki-500k",     2_381_304, 501_070, 783_743, 200, 64),
    "amazon-670k":   XMRShape("amazon-670k",   135_909,   670_091, 153_025, 75, 64),
    "amazon-3m":     XMRShape("amazon-3m",     337_067,   2_812_281, 742_507, 100, 64),
}

ENTERPRISE_SHAPE = XMRShape(
    # Paper §6: semantic product search, 100M products, d = 4M.
    "enterprise-100m", 4_000_000, 100_000_000, 10_000, 150, 64
)


def benchmark_queries(shape: XMRShape, n: int, rng: np.random.Generator) -> CSR:
    """Random queries matching a paper dataset's sparsity statistics."""
    return random_sparse_csr(n, shape.d, shape.query_nnz, rng)
