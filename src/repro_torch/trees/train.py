"""Per-level one-vs-rest ranker training (counterpart of ``repro.trees.train``).

For each stored tree level l the targets are the level-l ancestors of each
query's positive labels; rankers are logistic (paper eq. 1) and are trained
with *teacher-forced matched negatives*: node j's ranker only sees queries
positive for j's parent (the PECOS/Parabel recipe: it matches the
conditional factorization of eq. 2 and keeps training sets small).

Training is full-batch Adam on dense tensors, on the tree's device (the
card unless the caller names another). The products ``xd @ w`` and
``xdᵀ @ r`` are ``torch.matmul`` in true f32: the reference leaves them to
XLA, outside any Pallas kernel, so there is no kernel to port. The trained
weights go to the host once a level, are magnitude-pruned per column
(numpy, as in the reference) and handed to the chunked converters, closing
the loop: cluster -> train -> sparsify -> MSCM serve.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import XMRTree, resolve_device
from repro_torch.sparse.csr import CSC, CSR
from repro_torch.trees.cluster import TreeStructure, build_clustered_tree


@contextlib.contextmanager
def _true_f32() -> Iterator[None]:
    """f32 matrix products without TF32 inside the block, whatever the
    caller set; the caller's setting is restored after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _train_level(
    xd: torch.Tensor,   # f32 [n, d] dense queries
    y: torch.Tensor,    # f32 [n, L] binary node targets
    p: torch.Tensor,    # f32 [n, L] parent-positive mask (training set)
    *,
    steps: int = 150,
    lr: float = 0.5,
    l2: float = 1e-4,
) -> torch.Tensor:
    """Masked logistic regression for all L node rankers at once, on the
    tensors' device. Returns w [d, L].

    The loss is the reference's: mean masked BCE, ``sum(bce * p) /
    max(sum(p), 1) + l2 * sum(w * w)``, with ``bce = max(l, 0) - l * y +
    log1p(exp(-|l|))``. Its gradient is taken in closed form, ``xdᵀ(r p /
    denom) + 2 l2 w`` with ``r = σ(l) - y``, except ``r = -y`` where a
    logit is exactly 0: that is what the reference's ``jax.grad`` gives
    there (JAX 0.9 splits the tie of ``max`` 0.5 / 0.5 and gives ``|l|``
    slope +1 at 0, so the log1p term's -0.5 cancels max's +0.5), and every
    logit of step 1 is 0, as w starts at 0. Adam with β 0.9 / 0.999 and eps
    1e-8, its bias corrections in f32 from an f32 step count as ``lax.scan``
    carries it. Nothing here reads a value back to the host.
    """
    n, d = xd.shape
    L = y.shape[1]
    w = torch.zeros((d, L), dtype=torch.float32, device=xd.device)
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    t = torch.zeros((), dtype=torch.float32, device=xd.device)
    scale = p / torch.clamp(p.sum(), min=1.0)  # [n, L] d loss / d bce
    with _true_f32():
        for _ in range(steps):
            logits = xd @ w
            r = (torch.where(logits == 0, 0.0, torch.sigmoid(logits)) - y) * scale
            g = xd.T @ r + (2.0 * l2) * w
            t = t + 1.0
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - torch.pow(0.9, t))
            vh = v / (1.0 - torch.pow(0.999, t))
            w = w - lr * mh / (torch.sqrt(vh) + 1e-8)
    return w


def sparsify_columns(w: np.ndarray, nnz_per_col: int, *, min_abs: float = 1e-6) -> CSC:
    """Keep the top-|w| entries of each column (PECOS-style pruning)."""
    d, L = w.shape
    cols_i, cols_v = [], []
    k = min(nnz_per_col, d)
    for j in range(L):
        col = w[:, j]
        idx = np.argpartition(-np.abs(col), k - 1)[:k] if k < d else np.arange(d)
        idx = idx[np.abs(col[idx]) > min_abs]
        idx = np.sort(idx).astype(np.int32)
        cols_i.append(idx)
        cols_v.append(col[idx].astype(np.float32))
    return CSC.from_cols(cols_i, cols_v, (d, L))


@dataclasses.dataclass
class TrainedXMRModel:
    """Tree structure + trained chunked model + label mapping.

    ``level_seconds`` holds, for each level :func:`train_xmr_model` trained,
    the host wall seconds of its training (to the copy of w to the host)
    and of its sparsification; empty for a model built otherwise."""

    tree: XMRTree
    structure: TreeStructure
    level_seconds: List[Tuple[float, float]] = dataclasses.field(default_factory=list)

    def predict(
        self, x_idx, x_val, *, beam: int = 10, topk: int = 10, method: str = "mscm_dense"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [n,k], original-label ids [n,k]; -1 = padding)."""
        s, leaf_pos = self.tree.infer(
            x_idx, x_val, beam=beam, topk=topk, method=method
        )
        labels = self.structure.label_perm[leaf_pos.cpu().numpy()]
        return s.cpu().numpy(), labels


def leaf_targets(
    y: Sequence[np.ndarray], structure: TreeStructure
) -> List[np.ndarray]:
    """Map positive label ids -> leaf positions under the tree permutation."""
    inv = structure.label_to_leaf()
    return [inv[np.asarray(lbls, np.int64)] for lbls in y]


def train_xmr_model(
    x: CSR,
    y: Sequence[np.ndarray],
    n_labels: int,
    branching: int,
    rng: np.random.Generator,
    *,
    nnz_per_col: int = 32,
    steps: int = 150,
    structure: TreeStructure | None = None,
    device: str | torch.device | None = None,
) -> TrainedXMRModel:
    """Full pipeline: cluster -> per-level ranker training -> sparsify, with
    the training and the returned tree on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    n, d = x.shape
    if structure is None:
        structure = build_clustered_tree(x, y, n_labels, branching, rng)
    leaves = leaf_targets(y, structure)
    xd = torch.from_numpy(x.to_dense()).to(dev)

    weights: List[CSC] = []
    seconds: List[Tuple[float, float]] = []
    prev_pos: np.ndarray | None = None  # [n, L_{l-1}] bool
    for level, size in enumerate(structure.level_sizes):
        yl = np.zeros((n, size), np.float32)
        for i, lp in enumerate(leaves):
            nodes = structure.ancestor_at_level(lp, level)
            yl[i, nodes] = 1.0
        if prev_pos is None:
            pl = np.ones((n, size), np.float32)
        else:
            pl = prev_pos[:, np.arange(size) // structure.branching]
        t0 = time.perf_counter()
        w = _train_level(xd, torch.from_numpy(yl).to(dev), torch.from_numpy(pl).to(dev),
                         steps=steps).cpu().numpy()
        t1 = time.perf_counter()
        weights.append(sparsify_columns(w, nnz_per_col))
        seconds.append((t1 - t0, time.perf_counter() - t1))
        prev_pos = yl
    tree = XMRTree.from_weight_matrices(weights, branching, device=dev)
    return TrainedXMRModel(tree=tree, structure=structure, level_seconds=seconds)
