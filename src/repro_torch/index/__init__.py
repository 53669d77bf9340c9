"""Label-partitioned index (counterpart of ``repro.index``). So far only the
planner's :func:`~repro_torch.index.planner.reference_topk_width`, which the
engine's beam-tier check needs; the partitioned index itself is ROADMAP.md
queue 1 item 10."""

from repro_torch.index.planner import reference_topk_width

__all__ = ["reference_topk_width"]
