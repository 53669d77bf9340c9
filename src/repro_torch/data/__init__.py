from repro_torch.data.lm_data import PrefetchingLoader, batch_at_step
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
    "PrefetchingLoader",
    "XMRDataset",
    "XMRShape",
    "batch_at_step",
    "benchmark_queries",
    "load_svmlight_xmr",
    "scaled_shape",
    "synthetic_labeled_dataset",
]
