from repro_torch.core.chunked import ChunkedLayer, ColumnELLLayer
from repro_torch.core.tree import METHODS, TreeLayerArrays, XMRTree

__all__ = [
    "ChunkedLayer",
    "ColumnELLLayer",
    "XMRTree",
    "TreeLayerArrays",
    "METHODS",
]
