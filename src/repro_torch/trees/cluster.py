"""Label-tree structure: a perfect B-ary tree over a label permutation.

The port's own copy of the structural half of ``repro.trees.cluster``
(numpy). PIFA embeddings and balanced-bisection clustering belong to the
training path and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
