from repro_torch.trees.cluster import TreeStructure, build_tree_structure

__all__ = ["TreeStructure", "build_tree_structure"]
