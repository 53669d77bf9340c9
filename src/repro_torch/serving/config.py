"""Serving configuration: the inference knobs of the reference's
``ServeConfig``, with the same names and defaults, so one configuration
drives both packages.

The reference's nested groups (admission, partition, fleet, quant, slo) and
multi-device dispatch are not ported yet: asking for any of them raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: Options of the reference's config this port does not run yet:
#: name -> (the value that keeps it off, ROADMAP.md item).
UNPORTED_OPTIONS = {
    "admission": (None, "queue 1 item 9 (serving core: batcher, admission)"),
    "slo": (None, "queue 1 item 9 (serving core: SLO beam tiers)"),
    "target_p99_ms": (None, "queue 1 item 9 (serving core: SLO beam tiers)"),
    "quant": (None, "queue 1 item 8 (quantized tiers)"),
    "tier": ("exact", "queue 1 item 8 (quantized tiers)"),
    "partition": (None, "queue 1 item 10 (partitioned index)"),
    "partitions": (1, "queue 1 item 10 (partitioned index)"),
    "fleet": (None, "queue 1 item 11 (fleet and gateway)"),
}


@dataclasses.dataclass(init=False)
class ServeConfig:
    """Engine configuration (the reference's top-level inference knobs)."""

    beam: int = 10
    topk: int = 10
    method: str = "auto"          # "auto" resolves per device (see engine)
    ell_width: int = 256          # query nnz cap (pad/truncate)
    max_batch: int = 256
    score_mode: str = "prod"
    qt: int = 8                   # grouped-kernel query-tile height
    shards: int = 1               # data-parallel replicas: only 1 is ported

    def __init__(
        self,
        beam: int = 10,
        topk: int = 10,
        method: str = "auto",
        ell_width: int = 256,
        max_batch: int = 256,
        score_mode: str = "prod",
        qt: int = 8,
        shards: int = 1,
        **unported: Any,
    ) -> None:
        self.beam = beam
        self.topk = topk
        self.method = method
        self.ell_width = ell_width
        self.max_batch = max_batch
        self.score_mode = score_mode
        self.qt = qt
        self.shards = shards
        if shards != 1:
            raise NotImplementedError(
                f"shards={shards}: multi-device dispatch is not ported yet "
                "(ROADMAP.md queue 1 items 9-10)"
            )
        for name, value in unported.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError(f"ServeConfig got an unexpected keyword argument {name!r}")
            off, item = UNPORTED_OPTIONS[name]
            if value != off:
                raise NotImplementedError(
                    f"ServeConfig({name}={value!r}) is not ported yet: ROADMAP.md {item}"
                )
