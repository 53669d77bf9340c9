"""Serving configuration: the inference knobs of the reference's
``ServeConfig`` and its ``quant`` group (:class:`QuantConfig`), with the
same names and defaults, so one configuration drives both packages.

The reference's other nested groups (admission, partition, fleet, slo) and
multi-device dispatch are not ported yet: asking for any of them raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

#: Options of the reference's config this port does not run yet:
#: name -> (the value that keeps it off, ROADMAP.md item).
UNPORTED_OPTIONS = {
    "admission": (None, "queue 1 item 9 (serving core: batcher, admission)"),
    "slo": (None, "queue 1 item 9 (serving core: SLO beam tiers)"),
    "target_p99_ms": (None, "queue 1 item 9 (serving core: SLO beam tiers)"),
    "partition": (None, "queue 1 item 10 (partitioned index)"),
    "partitions": (1, "queue 1 item 10 (partitioned index)"),
    "fleet": (None, "queue 1 item 11 (fleet and gateway)"),
}


#: Valid :attr:`QuantConfig.tier` values.
QUANT_TIERS = ("exact", "int8", "int8_pruned", "fp8")


@dataclasses.dataclass
class QuantConfig:
    """Compressed-weight storage tier (:mod:`repro_torch.quant`).

    ``exact`` (default) serves the f32 tree unchanged; ``int8`` and ``fp8``
    store per-(chunk, column) symmetric codes and f32 scales, served through
    ``method="mscm_pallas_grouped_q"``; ``int8_pruned`` also keeps only the
    top ``prune_keep`` fraction of each chunk's rows. Accuracy is a measured
    contract (recall@k, score MAE), not a bitwise claim.
    """

    tier: str = "exact"
    prune_keep: float = 0.5  # row fraction kept by the pruned re-pack

    def __post_init__(self) -> None:
        if self.tier not in QUANT_TIERS:
            raise ValueError(f"tier={self.tier!r}; choose from {QUANT_TIERS}")
        if not 0.0 < self.prune_keep <= 1.0:
            raise ValueError(f"prune_keep must be in (0, 1]; got {self.prune_keep}")


_QUANT_FIELDS = frozenset(f.name for f in dataclasses.fields(QuantConfig))


@dataclasses.dataclass(init=False)
class ServeConfig:
    """Engine configuration (the reference's top-level inference knobs and
    its ``quant`` group)."""

    beam: int = 10
    topk: int = 10
    method: str = "auto"          # "auto" resolves per device (see engine)
    ell_width: int = 256          # query nnz cap (pad/truncate)
    max_batch: int = 256
    score_mode: str = "prod"
    qt: int = 8                   # grouped-kernel query-tile height
    shards: int = 1               # data-parallel replicas: only 1 is ported
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

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
        quant: QuantConfig | None = None,
        **flat: Any,
    ) -> None:
        self.beam = beam
        self.topk = topk
        self.method = method
        self.ell_width = ell_width
        self.max_batch = max_batch
        self.score_mode = score_mode
        self.qt = qt
        self.shards = shards
        self.quant = quant if quant is not None else QuantConfig()
        if not isinstance(self.quant, QuantConfig):
            raise TypeError(f"quant must be a QuantConfig; got {type(self.quant).__name__}")
        if shards != 1:
            raise NotImplementedError(
                f"shards={shards}: multi-device dispatch is not ported yet "
                "(ROADMAP.md queue 1 items 9-10)"
            )
        qnt = {k: v for k, v in flat.items() if k in _QUANT_FIELDS}
        if qnt:
            warnings.warn(
                f"flat ServeConfig kwarg(s) {sorted(qnt)} are deprecated; pass "
                "quant=QuantConfig(...) instead",
                DeprecationWarning,
                stacklevel=2,
            )
            # replace(), not setattr: never mutate a caller-shared group.
            self.quant = dataclasses.replace(self.quant, **qnt)
        for name, value in flat.items():
            if name in qnt:
                continue
            if name not in UNPORTED_OPTIONS:
                raise TypeError(f"ServeConfig got an unexpected keyword argument {name!r}")
            off, item = UNPORTED_OPTIONS[name]
            if value != off:
                raise NotImplementedError(
                    f"ServeConfig({name}={value!r}) is not ported yet: ROADMAP.md {item}"
                )

    # -- flat read-side forwarding (the reference's pre-v1 call sites) -------
    @property
    def tier(self) -> str:
        return self.quant.tier

    @property
    def prune_keep(self) -> float:
        return self.quant.prune_keep
