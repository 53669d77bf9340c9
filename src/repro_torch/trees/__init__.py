from repro_torch.trees.cluster import (
    TreeStructure,
    build_clustered_tree,
    build_tree_structure,
    pifa_embeddings,
)
from repro_torch.trees.train import TrainedXMRModel, sparsify_columns, train_xmr_model

__all__ = [
    "TrainedXMRModel",
    "TreeStructure",
    "build_clustered_tree",
    "build_tree_structure",
    "pifa_embeddings",
    "sparsify_columns",
    "train_xmr_model",
]
