from repro_torch.data.xmr_data import (
    ENTERPRISE_SHAPE,
    PAPER_SHAPES,
    XMRShape,
    benchmark_queries,
)

__all__ = ["ENTERPRISE_SHAPE", "PAPER_SHAPES", "XMRShape", "benchmark_queries"]
