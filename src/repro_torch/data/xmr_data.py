"""XMR datasets: shapes, synthetic generators and an SVMlight-style loader.

The port's own copy of ``repro.data.xmr_data`` (numpy; the same arrays from
the same ``rng`` stream, call for call). Two uses:

1. **Benchmark models**: inference latency depends only on the sparsity
   structure (d, L, nnz, branching, sibling overlap), so benchmark models
   are random at the paper's true dimensions.
2. **Training-path datasets**: small generative hierarchical datasets with
   real label structure, for the cluster -> train -> serve pipeline and P@k.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

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


def scaled_shape(shape: XMRShape, scale: float) -> XMRShape:
    """Shrink L and n_test (d and nnz preserved) for CPU-budget benchmarks."""
    return XMRShape(
        name=f"{shape.name}@{scale:g}",
        d=max(64, int(shape.d * min(1.0, scale * 4))),
        L=max(64, int(shape.L * scale)),
        n_test=max(16, int(min(shape.n_test, 2000) * scale)),
        query_nnz=shape.query_nnz,
        col_nnz=shape.col_nnz,
    )


# ---------------------------------------------------------------------------
# Labeled generative dataset (training path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class XMRDataset:
    name: str
    x_train: CSR
    y_train: List[np.ndarray]
    x_test: CSR
    y_test: List[np.ndarray]
    n_labels: int

    @property
    def d(self) -> int:
        return self.x_train.shape[1]


def synthetic_labeled_dataset(
    rng: np.random.Generator,
    *,
    name: str = "synth",
    n_labels: int = 256,
    d: int = 512,
    n_train: int = 1024,
    n_test: int = 256,
    proto_nnz: int = 24,
    query_nnz: int = 16,
    n_groups: int | None = None,
    noise: float = 0.25,
) -> XMRDataset:
    """Hierarchical generative model.

    Labels live in groups; each group has a sparse center, each label a
    sparse prototype = center + private features. A query picks a label and
    samples features from its prototype support (plus noise features), so
    sibling labels have correlated discriminative features: the structure
    both the clustering and MSCM's chunk layout rely on.
    """
    g = n_groups or max(1, int(np.sqrt(n_labels)))
    group_of = rng.integers(0, g, size=n_labels)
    group_centers = [
        rng.choice(d, size=min(d, proto_nnz), replace=False) for _ in range(g)
    ]
    protos: List[np.ndarray] = []
    for lbl in range(n_labels):
        c = group_centers[group_of[lbl]]
        keep = rng.random(len(c)) < 0.7
        priv = rng.choice(d, size=max(1, proto_nnz // 3), replace=False)
        protos.append(np.unique(np.concatenate([c[keep], priv])))

    def make_split(n: int) -> Tuple[CSR, List[np.ndarray]]:
        rows_i, rows_v, ys = [], [], []
        for _ in range(n):
            lbl = int(rng.integers(0, n_labels))
            support = protos[lbl]
            k = min(query_nnz, len(support))
            feat = rng.choice(support, size=k, replace=False)
            n_noise = max(0, int(query_nnz * noise))
            if n_noise:
                feat = np.concatenate([feat, rng.choice(d, size=n_noise)])
            feat = np.unique(feat).astype(np.int32)
            val = (np.abs(rng.standard_normal(len(feat))) + 0.1).astype(np.float32)
            rows_i.append(feat)
            rows_v.append(val)
            pos = [lbl]
            if rng.random() < 0.3:  # multi-label: add a sibling from the group
                sibs = np.nonzero(group_of == group_of[lbl])[0]
                pos.append(int(rng.choice(sibs)))
            ys.append(np.unique(pos))
        return CSR.from_rows(rows_i, rows_v, (n, d)), ys

    x_tr, y_tr = make_split(n_train)
    x_te, y_te = make_split(n_test)
    return XMRDataset(name, x_tr, y_tr, x_te, y_te, n_labels)


def benchmark_queries(shape: XMRShape, n: int, rng: np.random.Generator) -> CSR:
    """Random queries matching a paper dataset's sparsity statistics."""
    return random_sparse_csr(n, shape.d, shape.query_nnz, rng)


# ---------------------------------------------------------------------------
# SVMlight-style loader (the public XMC repository format):
#   <label>,<label>,... <feat>:<val> <feat>:<val> ...
# ---------------------------------------------------------------------------

def load_svmlight_xmr(path: str, d: int, n_labels: int) -> Tuple[CSR, List[np.ndarray]]:
    """Queries [n, d] and each one's label ids (those below ``n_labels``); a
    line whose first token holds a ``:`` has no labels."""
    rows_i, rows_v, ys = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if ":" in parts[0]:
                labels = np.zeros(0, np.int64)
                feats = parts
            else:
                labels = np.array(
                    [int(t) for t in parts[0].split(",") if t], np.int64
                )
                feats = parts[1:]
            idx, val = [], []
            for tok in feats:
                k, v = tok.split(":")
                idx.append(int(k))
                val.append(float(v))
            order = np.argsort(idx)
            rows_i.append(np.asarray(idx, np.int32)[order])
            rows_v.append(np.asarray(val, np.float32)[order])
            ys.append(labels[labels < n_labels])
    x = CSR.from_rows(rows_i, rows_v, (len(rows_i), d))
    return x, ys
