from repro_torch.data.xmr_data import (
    ENTERPRISE_SHAPE,
    PAPER_SHAPES,
    XMRDataset,
    XMRShape,
    benchmark_queries,
    load_svmlight_xmr,
    scaled_shape,
    synthetic_labeled_dataset,
)

__all__ = [
    "ENTERPRISE_SHAPE",
    "PAPER_SHAPES",
    "XMRDataset",
    "XMRShape",
    "benchmark_queries",
    "load_svmlight_xmr",
    "scaled_shape",
    "synthetic_labeled_dataset",
]
