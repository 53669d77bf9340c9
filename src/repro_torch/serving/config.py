"""Serving configuration: the reference's ``ServeConfig`` with its inference
knobs and its ``admission``, ``partition``, ``fleet``, ``quant`` and ``slo``
groups, with the same names, defaults and validation, so one configuration
drives both packages.

* :class:`AdmissionConfig` — the overload policy the
  :class:`~repro_torch.serving.batcher.MicroBatcher` applies at the queue;
* :class:`PartitionConfig` — the label-partitioned dispatch topology
  (:mod:`repro_torch.index`);
* :class:`FleetConfig` — the cross-process fleet's resilience: degraded
  serving and the supervisor's knobs (:mod:`repro_torch.serving.fleet`);
* :class:`QuantConfig` — the compressed-weight storage tier
  (:mod:`repro_torch.quant`);
* :class:`SLOConfig` — latency-SLO adaptive inference: a ladder of degraded
  beam tiers the batcher may pick per batch when the queue backs up
  (:mod:`repro_torch.serving.slo`). Off by default.

``shards=N`` (a power of two, at most ``max_batch``, checked by the engine)
splits each dispatched bucket over N device slots.

The pre-v1 flat kwargs (``queue_depth=``, ``partitions=``, ``tier=``, …)
are routed into their group with a :class:`DeprecationWarning`, and the
read side keeps flat properties, as in the reference.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Tuple, Union

@dataclasses.dataclass
class AdmissionConfig:
    """Overload policy consumed by the :class:`MicroBatcher` front end."""

    queue_depth: Union[int, str, None] = None  # bound | "auto" | unbounded
    shed_policy: str = "reject"                # "reject" | "shed-oldest"
    deadline_ms: Optional[float] = None        # default per-request deadline


@dataclasses.dataclass
class PartitionConfig:
    """Label-partitioned dispatch topology (:mod:`repro_torch.index`)."""

    partitions: int = 1                    # label-space partitions
    partition_level: Optional[int] = None  # split level (None = auto)
    # "level"     — per-level exchange, bitwise-exact
    # "pipelined" — exchange overlapped with the next level's product via
    #               speculative expansion; still bitwise-exact
    # "final"     — one merge, no per-level sync; dominates, not bitwise
    partition_sync: str = "level"
    beam_cache: int = 0                    # hot-beam LRU entries (0 = off)


#: Valid :attr:`FleetConfig.degraded_policy` values.
DEGRADED_POLICIES = ("serve_partial", "reject")


@dataclasses.dataclass
class FleetConfig:
    """Cross-process fleet resilience: degraded serving and supervision.

    ``degraded_policy`` decides what a partition loss mid-query means:

    * ``"serve_partial"`` (default) — complete the beam exchange over the
      surviving partitions and stamp the result ``degraded`` with the
      unsearched label ranges; survivor scores keep their exact bits.
    * ``"reject"`` — fail the query with a typed ``worker_unavailable``.

    The other knobs tune :class:`~repro_torch.serving.fleet.FleetSupervisor`:
    its sweep cadence, the bound of one liveness probe, the consecutive
    failed probes that turn ``SUSPECT`` into a restart, and the exponential
    backoff and attempt budget of the respawn loop.
    """

    degraded_policy: str = "serve_partial"
    poll_interval_s: float = 0.5   # supervisor sweep cadence
    ping_timeout_s: float = 2.0    # per-worker probe bound
    suspect_after: int = 2         # failed probes before a restart
    backoff_base_s: float = 0.25   # delay after the first failed respawn
    backoff_max_s: float = 10.0    # backoff doubles up to this cap
    restart_budget: int = 5        # respawn attempts before FAILED

    def __post_init__(self) -> None:
        if self.degraded_policy not in DEGRADED_POLICIES:
            raise ValueError(
                f"degraded_policy={self.degraded_policy!r}; choose from "
                f"{DEGRADED_POLICIES}"
            )


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


@dataclasses.dataclass
class SLOConfig:
    """Latency-SLO adaptive inference (:mod:`repro_torch.serving.slo`).

    ``target_p99_ms=None`` (default) disables tiering: the engine has one
    tier, the configured ``(beam, qt)``, and serving is bitwise that of a
    config without this group. With a target, the batcher picks a beam tier
    per batch from the queue depth and the batch's remaining budget; tier 0
    is always the full beam. ``tiers`` pins the degraded ladder as ``(beam,
    qt)`` pairs with strictly descending beams; empty derives ``beam // 2,
    beam // 4, …`` down to ``min_beam`` at the configured ``qt``. Every tier
    must keep the full beam's result width (checked at engine build).
    """

    target_p99_ms: Optional[float] = None  # None = adaptive tiering off
    tiers: Tuple[Tuple[int, int], ...] = ()  # explicit (beam, qt) ladder
    min_beam: int = 1                      # auto-ladder floor

    def __post_init__(self) -> None:
        if self.target_p99_ms is not None and self.target_p99_ms <= 0:
            raise ValueError(f"target_p99_ms must be positive; got {self.target_p99_ms}")
        if self.min_beam < 1:
            raise ValueError(f"min_beam must be >= 1; got {self.min_beam}")
        prev = None
        for pair in self.tiers:
            if len(tuple(pair)) != 2:
                raise ValueError(f"tiers entries are (beam, qt) pairs; got {pair!r}")
            b, q = int(pair[0]), int(pair[1])
            if b < 1 or q < 1:
                raise ValueError(f"tier (beam={b}, qt={q}) must be positive")
            if prev is not None and b >= prev:
                raise ValueError(
                    f"tier beams must be strictly descending; got "
                    f"{[int(p[0]) for p in self.tiers]}"
                )
            prev = b


#: Each group's name and class, in the order of the deprecation message.
_GROUPS = (("admission", AdmissionConfig), ("partition", PartitionConfig),
           ("fleet", FleetConfig), ("quant", QuantConfig), ("slo", SLOConfig))
#: Flat kwarg name -> the group it belongs to.
_GROUP_OF = {f.name: name for name, cls in _GROUPS for f in dataclasses.fields(cls)}


@dataclasses.dataclass(init=False)
class ServeConfig:
    """Engine and serving-tier configuration (see the module docstring)."""

    beam: int = 10
    topk: int = 10
    method: str = "auto"          # "auto" resolves per device (see engine)
    ell_width: int = 256          # query nnz cap (pad/truncate)
    max_batch: int = 256
    score_mode: str = "prod"
    qt: int = 8                   # grouped-kernel query-tile height
    shards: int = 1               # data-parallel device slots per dispatch
    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)
    partition: PartitionConfig = dataclasses.field(default_factory=PartitionConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)

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
        admission: AdmissionConfig | None = None,
        partition: PartitionConfig | None = None,
        fleet: FleetConfig | None = None,
        quant: QuantConfig | None = None,
        slo: SLOConfig | None = None,
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
        groups = dict(admission=admission, partition=partition, fleet=fleet, quant=quant,
                      slo=slo)
        for name, cls in _GROUPS:
            group = groups[name]
            if group is None:
                group = cls()
            elif not isinstance(group, cls):
                raise TypeError(f"{name} must be a {cls.__name__}; got {type(group).__name__}")
            setattr(self, name, group)
        unknown = sorted(set(flat) - set(_GROUP_OF))
        if unknown:
            raise TypeError(f"ServeConfig got unexpected keyword argument(s) {unknown}")
        if flat:
            by_group = {name: {k: v for k, v in flat.items() if _GROUP_OF[k] == name}
                        for name, _ in _GROUPS}
            warnings.warn(
                f"flat ServeConfig kwarg(s) "
                f"{[k for name, _ in _GROUPS for k in sorted(by_group[name])]} "
                "are deprecated; pass admission=AdmissionConfig(...) / "
                "partition=PartitionConfig(...) / fleet=FleetConfig(...) / "
                "quant=QuantConfig(...) / slo=SLOConfig(...) instead",
                DeprecationWarning,
                stacklevel=2,
            )
            # replace(), not setattr: never mutate a caller-shared group.
            for name, kw in by_group.items():
                if kw:
                    setattr(self, name, dataclasses.replace(getattr(self, name), **kw))

    # -- flat read-side forwarding (the reference's pre-v1 call sites) -------
    @property
    def queue_depth(self) -> Union[int, str, None]:
        return self.admission.queue_depth

    @property
    def shed_policy(self) -> str:
        return self.admission.shed_policy

    @property
    def deadline_ms(self) -> Optional[float]:
        return self.admission.deadline_ms

    @property
    def partitions(self) -> int:
        return self.partition.partitions

    @property
    def partition_level(self) -> Optional[int]:
        return self.partition.partition_level

    @property
    def partition_sync(self) -> str:
        return self.partition.partition_sync

    @property
    def beam_cache(self) -> int:
        return self.partition.beam_cache

    @property
    def degraded_policy(self) -> str:
        return self.fleet.degraded_policy

    @property
    def tier(self) -> str:
        return self.quant.tier

    @property
    def prune_keep(self) -> float:
        return self.quant.prune_keep

    @property
    def target_p99_ms(self) -> Optional[float]:
        return self.slo.target_p99_ms
