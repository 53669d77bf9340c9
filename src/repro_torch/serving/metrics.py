"""Serving-side latency recorder (counterpart of
``repro.serving.metrics.LatencyStats``).

Per-query samples (the online setting) and amortized batch-call averages
(the batch setting, where overlapped chunks make individual per-query times
meaningless) are kept in separate series, so percentiles stay percentiles
over individual queries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def _percentiles(arr: np.ndarray) -> Dict[str, float]:
    return {
        "avg_ms": float(arr.mean()),
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
    }


@dataclasses.dataclass
class LatencyStats:
    """Latency recorder with per-query and amortized series kept distinct."""

    per_query_ms: List[float] = dataclasses.field(default_factory=list)
    amortized_ms: List[float] = dataclasses.field(default_factory=list)
    amortized_queries: int = 0

    def record(self, query_s: float, n_queries: int = 1) -> None:
        """Record a per-query sample; ``n_queries > 1`` is an amortized call
        average and goes to the amortized series."""
        if n_queries > 1:
            self.record_amortized(query_s, n_queries)
        else:
            self.per_query_ms.append(1e3 * query_s)

    def record_amortized(self, total_s: float, n_queries: int) -> None:
        """Record one batch call: total wall time over ``n_queries``."""
        self.amortized_ms.append(1e3 * total_s / max(n_queries, 1))
        self.amortized_queries += n_queries

    def summary(self) -> dict:
        out: dict = {"count": len(self.per_query_ms)}
        if self.per_query_ms:
            out.update(_percentiles(np.asarray(self.per_query_ms)))
        if self.amortized_ms:
            arr = np.asarray(self.amortized_ms)
            out["amortized"] = {
                "calls": len(arr),
                "queries": self.amortized_queries,
                "avg_ms_per_query": float(arr.mean()),
            }
        return out
