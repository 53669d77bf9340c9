"""Scatter-gather planner (counterpart of ``repro.index.planner``).

Only :func:`reference_topk_width` is ported so far: the serving engine
checks each beam tier against it. The planner itself comes with the
partitioned index (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

from typing import Sequence


def reference_topk_width(
    n_cols: Sequence[int], branching: Sequence[int], beam: int, topk: int
) -> int:
    """Output width of the unpartitioned ``infer`` for these settings.

    Mirrors the traversal's clamps: ``next_b = min(beam-or-topk, n_cols)``
    further clamped by the candidate count ``b · B``.
    """
    b = 1
    for li, ncol in enumerate(n_cols):
        want = topk if li == len(n_cols) - 1 else beam
        b = min(want, int(ncol), b * int(branching[li]))
    return b
