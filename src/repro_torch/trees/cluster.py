"""Label-tree construction: PIFA embeddings + recursive balanced bisection.

The port's own copy of ``repro.trees.cluster`` (numpy, offline host code in
both packages; the inference path never calls it). The operations run in
the reference's order (``out[lbl, idx] += val`` in query order, ``sub @
c.T``, stable argsorts, ``np.allclose``), so the same ``rng`` gives the same
label permutation, bitwise.

* **PIFA** (positive instance feature aggregation): each label's embedding is
  the L2-normalized sum of its positive training queries.
* **Hierarchical clustering**: recursive *balanced* 2-means orders the labels
  so that similar labels are adjacent; the ordered list is then cut into a
  perfect B-ary tree. Every chunk holds B real siblings, and sibling rankers
  see near-identical positive sets: the origin of the correlated column
  supports that MSCM exploits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.sparse.csr import CSR


def pifa_embeddings(x: CSR, y: Sequence[np.ndarray], n_labels: int) -> np.ndarray:
    """Dense [L, d] PIFA label embeddings (L2-normalized).

    ``y[i]`` lists the positive label ids of query i.
    """
    n, d = x.shape
    out = np.zeros((n_labels, d), dtype=np.float32)
    for i in range(n):
        idx, val = x.row(i)
        for lbl in y[i]:
            out[lbl, idx] += val
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return out / norms


def _balanced_bisect(emb: np.ndarray, ids: np.ndarray, rng: np.random.Generator,
                     iters: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced 2-means: split ids into two equal halves by cluster affinity."""
    m = len(ids)
    if m <= 2:
        return ids[: m // 2], ids[m // 2 :]
    sub = emb[ids]
    c = sub[rng.choice(m, size=2, replace=False)].copy()  # [2, d]
    for _ in range(iters):
        score = sub @ c.T                     # [m, 2] cosine affinity
        margin = score[:, 0] - score[:, 1]
        order = np.argsort(-margin, kind="stable")
        half = m // 2
        left, right = order[:half], order[half:]
        new_c = np.stack([sub[left].mean(0), sub[right].mean(0)])
        nrm = np.linalg.norm(new_c, axis=1, keepdims=True)
        nrm[nrm == 0] = 1.0
        new_c = new_c / nrm
        if np.allclose(new_c, c, atol=1e-6):
            c = new_c
            break
        c = new_c
    score = sub @ c.T
    margin = score[:, 0] - score[:, 1]
    order = np.argsort(-margin, kind="stable")
    half = m // 2
    return ids[order[:half]], ids[order[half:]]


def cluster_label_order(
    emb: np.ndarray, rng: np.random.Generator, *, min_leaf: int = 2
) -> np.ndarray:
    """Similarity-preserving label ordering via recursive balanced bisection."""
    out: List[np.ndarray] = []

    def rec(ids: np.ndarray):
        if len(ids) <= min_leaf:
            out.append(ids)
            return
        l, r = _balanced_bisect(emb, ids, rng)
        rec(l)
        rec(r)

    rec(np.arange(emb.shape[0]))
    return np.concatenate(out)


@dataclasses.dataclass
class TreeStructure:
    """A perfect B-ary tree over a label permutation.

    ``level_sizes[l]`` = number of nodes at stored level l (level 0 here is
    the paper's level 2 — children of the root). ``label_perm[j]`` maps tree
    leaf position j -> original label id; positions >= n_labels are padding.
    """

    label_perm: np.ndarray        # [n_leaf_slots] int64, padded with -1
    level_sizes: Tuple[int, ...]  # e.g. (B, B^2, ..., B^depth)
    branching: int
    n_labels: int

    @property
    def depth(self) -> int:
        return len(self.level_sizes)

    def leaf_to_label(self, leaf_pos: np.ndarray) -> np.ndarray:
        return self.label_perm[leaf_pos]

    def label_to_leaf(self) -> np.ndarray:
        inv = np.full(self.n_labels, -1, np.int64)
        for pos, lbl in enumerate(self.label_perm):
            if lbl >= 0:
                inv[lbl] = pos
        return inv

    def ancestor_at_level(self, leaf_pos: np.ndarray, level: int) -> np.ndarray:
        """Node id at stored level ``level`` containing each leaf position."""
        span = 1
        for l in range(level + 1, self.depth):
            span *= self.branching
        return leaf_pos // span


def build_tree_structure(
    n_labels: int, branching: int, *, max_depth: int | None = None
) -> TreeStructure:
    """Perfect B-ary tree: depth = ceil(log_B n_labels), padded leaf slots."""
    b = int(branching)
    depth = 1
    while b**depth < n_labels:
        depth += 1
    if max_depth is not None:
        depth = min(depth, max_depth)
    sizes = tuple(b**l for l in range(1, depth + 1))
    slots = sizes[-1]
    perm = np.full(slots, -1, np.int64)
    perm[:n_labels] = np.arange(n_labels)
    return TreeStructure(
        label_perm=perm, level_sizes=sizes, branching=b, n_labels=n_labels
    )


def build_clustered_tree(
    x: CSR,
    y: Sequence[np.ndarray],
    n_labels: int,
    branching: int,
    rng: np.random.Generator,
) -> TreeStructure:
    """PIFA + balanced bisection ordering + perfect B-ary tree."""
    emb = pifa_embeddings(x, y, n_labels)
    order = cluster_label_order(emb, rng)
    tree = build_tree_structure(n_labels, branching)
    tree.label_perm[: n_labels] = order
    return tree
