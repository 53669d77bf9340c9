"""Scatter-gather query planner over a :class:`PartitionedIndex`
(counterpart of ``repro.index.planner``).

Query path (``sync="level"``, bitwise the unpartitioned tree):

1. **route**: the replicated router head runs the ordinary beam search over
   the levels above the split, giving the global beam;
2. **scatter**: every partition scores the beam rows it owns (the others
   park on its phantom chunk) through
   :func:`repro_torch.core.tree.owned_level_combined`, the in-tree
   arithmetic on sliced layers with the same ELL pad widths;
3. **gather + select**: the coordinator reassembles the global ``[n, b, B]``
   candidates from the owners and applies the canonical (score desc, id asc)
   :func:`~repro_torch.core.beam.beam_select`. Steps 2-3 repeat per
   partitioned level; the last select is the global top-k.

``sync="pipelined"`` keeps that contract with less exchanged: each partition
selects locally over the candidates it owns (:func:`_local_select`, the same
canonical order, unowned rows id-shifted past every real candidate so they
lose every tie) and speculatively expands its survivors through the next
level's product at once; every global survivor is in its owner's local beam,
so the canonical merge of the P local beams (:func:`_merge_beams`) *is* the
global select, and :func:`_reconcile_select` aligns the winners with the
speculative expansion (a per-row search, no second product). A partition's
level-(l+1) product depends on the merge of level l-1, not l, so the
exchange overlaps the next level's products. ``sync="final"`` runs each
partition's whole sub-tree from the router handoff and merges once: its
top-k dominates the exact one (every score >= its exact counterpart), but is
not bitwise.

Canonical order here is the port's packed-key order
(:func:`~repro_torch.core.beam.topk_canonical`). Local beams repeat ids:
every unowned row's children are shifted onto the junk parent ``n_chunks``,
so each unowned row offers the same junk ids ``n_chunks·B + j``. Ordering
them by (score, id) would pick child 0 of every junk row before child 1 of
any; the reference's local select takes the lowest *position* among equal
scores after a stable sort by parent id (``lax.top_k``), which picks the
junk children of one row in turn. :func:`_local_select` keys on that
position, so its local beam is the reference's, junk ids included. The
merges (:func:`_merge_beams`, :func:`merge_topk`) key on (score, id): there a
repeat is the same id with the same score, exactly ``NEG_INF``, so any order
among repeats gives the same bits.

Devices and streams: with a :class:`~repro_torch.index.placement.Placement`
each partition runs on its column's device slots (batch rows split over the
column's data rows), each slot on a CUDA stream of its own, and the router,
merges and selects on the coordinator's stream. Hand-offs between slots are
events, ``record_stream`` and, between devices, copies
(:func:`repro_torch.distributed.sharding.send`); the call waits for no
stream on the host, and the caller's stream waits for the coordinator's
before the results are handed back. Without a placement everything runs on
the caller's stream, on the index's device. Same arithmetic, same bits.

With ``cache_entries > 0`` a :class:`~repro_torch.index.cache.HotBeamCache`
skips partitions that own no row of the router beam (bitwise safe; one
small device-to-host copy of the beam per batch, hence opt-in).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import mscm as mscm_lib
from repro_torch.core.beam import NEG_INF, beam_select, topk_canonical
from repro_torch.core.tree import _NEEDS_DENSE, check_method, owned_level_combined
from repro_torch.distributed.sharding import Slot, canonical_device, row_slices, send
from repro_torch.index.cache import HotBeamCache
from repro_torch.index.partition import PartitionedIndex
from repro_torch.index.placement import Placement


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


def _local_select(
    parent_ids: torch.Tensor,  # int [n, b] GLOBAL chunk ids at this level
    combined: torch.Tensor,    # f32 [n, b, B] this partition's owned candidates
    owned: torch.Tensor,       # bool [n, b]
    *,
    n_cols: int,               # valid columns at this level
    n_chunks: int,             # GLOBAL chunk count at this level (junk shift)
    next_b: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition-local canonical select: the speculation step.

    The coordinator's ``(score desc, id asc)`` order over the partition's
    own candidates. Unowned rows are shifted onto the junk parent
    ``n_chunks`` (one past the last real chunk anywhere in the tree), so
    their ``NEG_INF`` children carry ids above every real or padding
    candidate and lose every tie: the local beam is then a superset of the
    partition's global survivors, even of those scoring exactly ``NEG_INF``.
    Returns ``(ids [n, k], scores [n, k])``, ``k = min(next_b, b·B)``.
    """
    n, b = parent_ids.shape
    B = combined.shape[-1]
    dev = parent_ids.device
    shifted = torch.where(owned, parent_ids, n_chunks)
    # Ordered by parent id (stable: junk rows keep their order), the flat
    # candidate positions ascend with the child ids, so (score desc,
    # position asc) is the canonical order on distinct ids and, on the
    # repeated junk ids, the reference's lowest-index rule (module docstring).
    p_sorted, order = torch.sort(shifted, dim=1, stable=True)
    c_sorted = combined.gather(1, order[..., None].expand(-1, -1, B))
    child_ids = (p_sorted[:, :, None] * B + torch.arange(B, device=dev)).reshape(n, b * B)
    scores = torch.where(child_ids < n_cols, c_sorted.reshape(n, b * B), NEG_INF)
    pos = torch.arange(b * B, device=dev).expand(n, -1)
    # k is the reference's width clamp (slicing semantics).
    top_pos, top_scores = topk_canonical(scores, pos, min(next_b, b * B))
    return child_ids.gather(1, top_pos), top_scores


def _reconcile(
    winner_ids: torch.Tensor,     # int [n, w] canonical global beam (level l-1)
    spec_ids: torch.Tensor,       # int [n, w] speculative local beam (level l-1)
    spec_combined: torch.Tensor,  # f32 [n, w, B] speculative level-l candidates
    chunk_start: int,             # partition's first chunk at level l
    chunk_count: int,             # partition's real chunks at level l
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align the speculative expansion with the canonical global beam.

    Each globally selected parent is looked up in the id-sorted speculative
    beam (a per-row ``searchsorted``, left side) and its precomputed row is
    gathered. Winners this partition owns are always there (see
    :func:`_local_select`); every other row is pinned to exactly ``NEG_INF``,
    the bits :func:`~repro_torch.core.tree.owned_level_combined` gives it.
    Returns ``(combined [n, w, B], owned [n, w])`` in beam order.
    """
    owned = (winner_ids >= chunk_start) & (winner_ids < chunk_start + chunk_count)
    sorted_ids, order = torch.sort(spec_ids, dim=1, stable=True)
    winners = winner_ids.to(sorted_ids.dtype).contiguous()
    pos = torch.searchsorted(sorted_ids.contiguous(), winners)
    pos = pos.clamp(0, spec_ids.shape[1] - 1)
    hit = sorted_ids.gather(1, pos) == winners
    src = order.gather(1, pos)
    combined = spec_combined.gather(
        1, src[..., None].expand(-1, -1, spec_combined.shape[-1]))
    mask = owned & hit
    return torch.where(mask[..., None], combined, NEG_INF), mask


def _reconcile_select(
    winner_ids: torch.Tensor,
    spec_ids: torch.Tensor,
    spec_combined: torch.Tensor,
    chunk_start: int,
    chunk_count: int,
    *,
    n_cols: int,
    n_chunks: int,
    next_b: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconcile, then the next local select: the partition's cheap step
    between two speculative products."""
    combined, owned = _reconcile(winner_ids, spec_ids, spec_combined, chunk_start,
                                 chunk_count)
    return _local_select(winner_ids, combined, owned, n_cols=n_cols, n_chunks=n_chunks,
                         next_b=next_b)


def _merge_beams(
    ids: Sequence[torch.Tensor],     # per partition: int [n, w]
    scores: Sequence[torch.Tensor],  # per partition: f32 [n, w]
    *,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical merge of the partitions' local beams, which is the global
    select: every global survivor is in its owner's local beam, and the
    order is total. ``width`` carries the unpartitioned ``min(next_b, b·B)``
    clamp. Returns ``(ids, scores)``."""
    with obs.span("plan.gather_select", device=scores[0].device):
        merged_scores, merged_ids = merge_topk(
            torch.cat(list(scores), dim=1), torch.cat(list(ids), dim=1), width=width)
    return merged_ids, merged_scores


def _gather_select(
    parent_ids: torch.Tensor,
    parts_combined: Sequence[torch.Tensor],
    parts_owned: Sequence[torch.Tensor],
    *,
    n_cols: int,
    next_b: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The owners' slices composed into the global candidates, then the
    canonical select. A row no partition owns stays ``NEG_INF``, as the
    unpartitioned traversal's mask pins it."""
    with obs.span("plan.gather_select", device=parent_ids.device):
        acc = torch.full_like(parts_combined[0], NEG_INF)
        for combined, owned in zip(parts_combined, parts_owned):
            acc = torch.where(owned[..., None], combined, acc)
        return beam_select(parent_ids, acc, n_cols, next_b)


def merge_topk(
    scores: torch.Tensor, labels: torch.Tensor, *, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical (score desc, id asc) top-``width`` of concatenated
    per-partition candidates: the ``sync="final"`` merge. Returns
    ``(scores, ids)``."""
    ids, top_scores = topk_canonical(scores, labels, width)
    return top_scores, ids


SYNC_MODES = ("level", "pipelined", "final")


class TransportDegraded(RuntimeError):
    """A partition was lost mid-exchange but the batch is retryable.

    Raised by a transport whose degraded policy is ``"serve_partial"``
    after it has removed the lost partition from its live set; the
    coordinator replays the batch from ``begin`` over the survivors.
    """

    def __init__(self, pid: int, cause: BaseException) -> None:
        super().__init__(f"partition {pid} lost mid-exchange: {cause}")
        self.pid = pid
        self.cause = cause


class BeamTransport:
    """Where the pipelined exchange's partition halves run.

    The coordinator (:meth:`ScatterGatherPlanner._infer_transport`) keeps
    the router head and the per-level merge; a transport runs the P
    partitions' score-and-speculate halves, in this process or in workers.

    Protocol, per query batch:

    * :meth:`begin`: ship the batch (ELL ``idx``/``val``) and the router
      handoff beam; every partition computes its level-``li0`` local beam
      and speculatively expands level ``li0+1``. Returns the P local beams
      ``[(ids [n, w], scores [n, w]), ...]`` in partition order.
    * :meth:`step`: ship the canonical winners of level ``level - 1``;
      every partition reconciles its speculation, selects level ``level``
      locally and speculates ``level + 1``. Returns the P local beams.

    Everything crosses as host ``numpy``: the ``[n, w]`` beams are the only
    per-level traffic.
    """

    @property
    def n_partitions(self) -> int:
        raise NotImplementedError

    def begin(
        self,
        x_idx: np.ndarray,
        x_val: np.ndarray,
        parent_ids: np.ndarray,
        scores: np.ndarray,
        *,
        beam: Optional[int] = None,
        qt: Optional[int] = None,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """``beam``/``qt`` override the partitions' configured settings for
        this batch only (adaptive beam tiers); ``None`` keeps them, and the
        coordinator omits them unless degraded."""
        raise NotImplementedError

    def step(
        self, level: int, winner_ids: np.ndarray
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def down_partitions(self) -> List[int]:
        """Partitions excluded from the current batch (degraded mode); by
        default none."""
        return []


def _cat_rows(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class ScatterGatherPlanner:
    """Executes partitioned queries; see the module docstring for the path.

    With ``placement`` each partition's layers are copied onto its column's
    devices at construction and the router head onto the coordinator's;
    without one, everything runs where the index lies.
    """

    def __init__(
        self,
        index: PartitionedIndex,
        *,
        beam: int = 10,
        topk: int = 10,
        method: str = "mscm_dense",
        score_mode: str = "prod",
        qt: int = 8,
        sync: str = "level",
        placement: Optional[Placement] = None,
        cache_entries: int = 0,
        transport: Optional[BeamTransport] = None,
    ) -> None:
        if sync not in SYNC_MODES:
            raise ValueError(f"sync={sync!r}; choose from {SYNC_MODES}")
        check_method(method)
        self.transport = None
        if transport is not None:
            self._check_transport(sync, cache_entries, transport)
            self.transport = transport
        #: Degraded-batch info from the most recent :meth:`infer` over a
        #: transport: ``None`` when every partition took part, else
        #: ``{"partitions": [pid, ...], "label_ranges": [(lo, hi), ...]}``.
        self.last_degraded: Optional[dict] = None
        self.index = index
        self.beam = beam
        self.topk = topk
        self.method = method
        self.score_mode = score_mode
        self.qt = qt
        self.sync = sync
        self.placement = placement
        if placement is not None:
            if len(placement.slots) != index.n_partitions:
                raise ValueError(
                    f"placement covers {len(placement.slots)} partitions, "
                    f"index has {index.n_partitions}"
                )
            self._coord = placement.coordinator
            self._slots = placement.slots
        else:
            dev = canonical_device(index.parts[0].device)
            self._coord = Slot(dev)
            self._slots = [[self._coord] for _ in index.parts]
        # One copy of a partition per distinct device of its column.
        self._trees = [
            [part.to(slot.device) for slot in slots]
            for part, slots in zip(index.parts, self._slots)
        ]
        self.head = index.head.to(self._coord.device)
        self._needs_dense = method in _NEEDS_DENSE
        # The router head is always f32 (only partitions are quantized), so a
        # quantized method routes through its exact grouped twin.
        self._router_method = (
            "mscm_pallas_grouped" if method == "mscm_pallas_grouped_q" else method
        )
        self.cache: Optional[HotBeamCache] = None
        if cache_entries:
            if sync == "final":
                # The final merge traverses every partition, so a cache would
                # be built and never consulted: refuse rather than no-op.
                raise ValueError(
                    'cache_entries is only meaningful for the exact sync '
                    'modes ("level"/"pipelined"), not sync="final"'
                )
            bounds = [p.chunk_start for p in index.manifest.partitions]
            bounds.append(index.manifest.partitions[-1].chunk_end)
            self.cache = HotBeamCache(cache_entries, bounds)

    @property
    def parts(self) -> List:
        """Each partition's tree on its first device slot."""
        return [trees[0] for trees in self._trees]

    # -- transport (cross-process partitions) -------------------------------
    def _check_transport(
        self, sync: str, cache_entries: int, transport: BeamTransport
    ) -> None:
        if sync != "pipelined":
            raise ValueError(
                'a BeamTransport requires sync="pipelined" (the only mode '
                "whose per-level exchange is the tiny local-beam protocol); "
                f"got sync={sync!r}"
            )
        if cache_entries:
            raise ValueError(
                "beam_cache is incompatible with a BeamTransport: the "
                "hot-beam owner-set skip is a host-side optimization of the "
                "in-process scatter, and remote workers always participate"
            )

    def set_transport(self, transport: Optional[BeamTransport]) -> None:
        """Route the partition halves through ``transport`` (None = local).
        The coordinator keeps the router head and the per-level merge."""
        if transport is not None:
            self._check_transport(
                self.sync, 0 if self.cache is None else 1, transport
            )
            if transport.n_partitions != self.index.n_partitions:
                raise ValueError(
                    f"transport serves {transport.n_partitions} partitions, "
                    f"index has {self.index.n_partitions}"
                )
        self.transport = transport

    def _infer_transport(self, x_idx, x_val, parent_ids, scores, *,
                         beam: int, qt: int):
        """Coordinator half of the pipelined exchange over a transport.

        A transport that loses a partition mid-exchange and may serve
        partially raises :class:`TransportDegraded` after shrinking its live
        set; the batch is then replayed over the survivors (each replay
        follows the permanent loss of a partition, so the loop ends).
        Survivors' labels keep their exact bits: a path's score does not
        depend on which other candidates shared the beam.
        """
        while True:
            try:
                w_scores, w_ids = self._transport_exchange(
                    x_idx, x_val, parent_ids, scores, beam=beam, qt=qt
                )
                break
            except TransportDegraded:
                continue  # replay over the survivors
        down = sorted(self.transport.down_partitions())
        if down:
            infos = self.index.manifest.partitions
            self.last_degraded = {
                "partitions": down,
                "label_ranges": [
                    (int(infos[p].label_start), int(infos[p].label_end))
                    for p in down
                ],
            }
        return w_scores, w_ids

    def _transport_exchange(self, x_idx, x_val, parent_ids, scores, *,
                            beam: int, qt: int):
        """One full begin/step/merge pass over the transport (the width and
        level recurrence of :meth:`_infer_pipelined`)."""
        idx = self.index
        depth = len(idx.n_cols)
        width = parent_ids.shape[1]  # router handoff beam width
        # Tier overrides ride the begin header only when they differ from
        # the configured settings.
        overrides = {}
        if beam != self.beam:
            overrides["beam"] = beam
        if qt != self.qt:
            overrides["qt"] = qt
        beams = self.transport.begin(
            x_idx.cpu().numpy(), x_val.cpu().numpy(),
            parent_ids.cpu().numpy(), scores.cpu().numpy(), **overrides,
        )
        dev = self._coord.device
        w_ids = w_scores = None
        for li in range(idx.level, depth):
            is_last = li == depth - 1
            next_b = min(self.topk if is_last else beam, idx.n_cols[li])
            width = min(next_b, width * idx.branching[li])
            if li > idx.level:
                beams = self.transport.step(li, w_ids.cpu().numpy())
            w_ids, w_scores = _merge_beams(
                [torch.as_tensor(np.asarray(i), device=dev).to(torch.int64) for i, _ in beams],
                [torch.as_tensor(np.asarray(s), device=dev) for _, s in beams],
                width=width,
            )
        return w_scores, w_ids

    # -- query path ---------------------------------------------------------
    def _route(self, x_idx: torch.Tensor, x_val: torch.Tensor, *, beam: int, qt: int):
        """Router head: the global beam after the levels above the split."""
        with obs.span("plan.route"):
            return self.head.infer(
                x_idx, x_val, beam=beam, topk=beam, method=self._router_method,
                score_mode=self.score_mode, qt=qt,
            )

    def _active_partitions(self, parent_ids: torch.Tensor) -> List[int]:
        """Partitions taking part in this batch: all of them without a cache
        (no host sync); with one, the cached owners of each row's router
        beam (a partition owning no row is skipped at every level)."""
        if self.cache is None:
            return list(range(self.index.n_partitions))
        return self.cache.active_partitions(parent_ids.cpu().numpy())

    def _partition_inputs(self, x_idx, x_val, active: Sequence[int], rows):
        """Per partition, per data row: ``(xi, xv, x_dense)`` of the row's
        queries on the row's slot. The dense ``[n, d+1]`` table is the
        expensive piece (d can be millions): one per device slot, shared by
        the partitions placed on it."""
        out: Dict[int, list] = {}
        by_slot: Dict[Slot, tuple] = {}
        with obs.span("plan.inputs"):
            for pid in active:
                out[pid] = []
                for slot, (r0, r1) in zip(self._slots[pid], rows):
                    if slot not in by_slot:
                        xi, xv = send((x_idx[r0:r1], x_val[r0:r1]), self._coord, slot)
                        with slot.enter():
                            xd = (mscm_lib.scatter_dense(xi, xv, self.index.d)
                                  if self._needs_dense else None)
                        by_slot[slot] = (xi, xv, xd)
                    out[pid].append(by_slot[slot])
        return out

    def infer(
        self, x_idx: torch.Tensor, x_val: torch.Tensor, *,
        beam: Optional[int] = None, qt: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global ``(scores [n, k], labels [n, k])`` for a query batch, on the
        queries' device, ready on the caller's stream.

        ``beam``/``qt`` override the configured settings for this call only
        (the adaptive tier path); every sync mode clamps widths from the
        effective beam, so results stay bitwise at that tier.
        """
        beam = self.beam if beam is None else int(beam)
        qt = self.qt if qt is None else int(qt)
        self.last_degraded = None
        caller = Slot.current(x_idx.device)
        coord = self._coord
        x_idx, x_val = send((x_idx, x_val), caller, coord)
        with coord.enter():
            scores, parent_ids = self._route(x_idx, x_val, beam=beam, qt=qt)
            if self.transport is not None:
                out = self._infer_transport(x_idx, x_val, parent_ids, scores, beam=beam,
                                            qt=qt)
                return send(out, coord, caller)
            active = (range(self.index.n_partitions) if self.sync == "final"
                      else self._active_partitions(parent_ids))
        run = {"level": self._infer_level, "pipelined": self._infer_pipelined,
               "final": self._infer_final}[self.sync]
        out = run(x_idx, x_val, parent_ids, scores, list(active), beam=beam, qt=qt)
        return send(out, coord, caller)

    def _level_owned(self, li, pid, r, inputs, parent_ids, scores, span, qt):
        """One partition's owned candidate slice of level ``li``, for the
        rows of data row ``r``, on that row's slot."""
        idx = self.index
        info = idx.manifest.partitions[pid]
        lay = self._trees[pid][r].layers[li - idx.level]
        xi, xv, xd = inputs[pid][r]
        return owned_level_combined(
            lay, idx.branching[li], idx.d, xi, xv, xd, parent_ids, scores,
            info.chunk_start * span, lay.chunk_rows.shape[0] - 1,  # minus phantom
            method=self.method, score_mode=self.score_mode, qt=qt,
        )

    def _infer_level(self, x_idx, x_val, parent_ids, scores, active, *,
                     beam: int, qt: int):
        idx, coord = self.index, self._coord
        rows = row_slices(x_idx.shape[0], len(self._slots[0]))
        inputs = self._partition_inputs(x_idx, x_val, active, rows)
        depth = len(idx.n_cols)
        for li in range(idx.level, depth):
            is_last = li == depth - 1
            next_b = min(self.topk if is_last else beam, idx.n_cols[li])
            # Chunk ranges at this level: the split ranges scaled by the
            # branching products of the levels in between (tree order).
            span = int(np.prod(idx.branching[idx.level:li], dtype=np.int64))
            combined, owned = [], []
            with obs.span("tree.level", level=li):
                for pid in active:
                    comb_r, own_r = [], []
                    for r, (slot, (r0, r1)) in enumerate(zip(self._slots[pid], rows)):
                        ids_p, sc_p = send((parent_ids[r0:r1], scores[r0:r1]), coord, slot)
                        with slot.enter():
                            comb_p, own_p = self._level_owned(li, pid, r, inputs, ids_p,
                                                              sc_p, span, qt)
                        comb_p, own_p = send((comb_p, own_p), slot, coord)
                        comb_r.append(comb_p)
                        own_r.append(own_p)
                    with coord.enter():
                        combined.append(_cat_rows(comb_r))
                        owned.append(_cat_rows(own_r))
            with coord.enter():
                parent_ids, scores = _gather_select(
                    parent_ids, combined, owned, n_cols=idx.n_cols[li], next_b=next_b)
        return scores, parent_ids

    def _infer_pipelined(self, x_idx, x_val, parent_ids, scores, active, *,
                         beam: int, qt: int):
        """Double-buffered exchange: level-l select ∥ level-(l+1) product.

        Each level, per partition and data row, on the row's slot: (1) the
        local canonical beam of level ``li`` (from the router handoff at the
        first partitioned level, else by reconciling the last winners with
        the speculative expansion); (2) its hand-off to the coordinator,
        enqueued before any heavy work; then on the coordinator (3) the
        canonical merge, which is the global select, dispatched before (4)
        each partition's speculative product for level ``li + 1``, which
        runs on its slot's stream while the coordinator merges.
        """
        idx, coord = self.index, self._coord
        infos = idx.manifest.partitions
        rows = row_slices(x_idx.shape[0], len(self._slots[0]))
        inputs = self._partition_inputs(x_idx, x_val, active, rows)
        depth = len(idx.n_cols)
        li0 = idx.level
        beam_p: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
        spec_comb: Dict[Tuple[int, int], torch.Tensor] = {}
        w_ids, w_scores = parent_ids, scores
        width = parent_ids.shape[1]  # router handoff beam width
        span = 1
        for li in range(li0, depth):
            is_last = li == depth - 1
            next_b = min(self.topk if is_last else beam, idx.n_cols[li])
            width = min(next_b, width * idx.branching[li])
            sel = dict(n_cols=idx.n_cols[li], n_chunks=idx.n_cols[li - 1], next_b=next_b)
            with obs.span("tree.level", level=li):
                # (1) local canonical beams for level li.
                for pid in active:
                    for r, (slot, (r0, r1)) in enumerate(zip(self._slots[pid], rows)):
                        if li == li0:  # scored from the router handoff
                            ids, sc = send((parent_ids[r0:r1], scores[r0:r1]), coord, slot)
                            with slot.enter():
                                comb, own = self._level_owned(li, pid, r, inputs, ids, sc, 1, qt)
                                beam_p[pid, r] = _local_select(ids, comb, own, **sel)
                        else:
                            (ids,) = send((w_ids[r0:r1],), coord, slot)
                            lay = self._trees[pid][r].layers[li - li0]
                            with slot.enter():
                                beam_p[pid, r] = _reconcile_select(
                                    ids, beam_p[pid, r][0], spec_comb[pid, r],
                                    infos[pid].chunk_start * span, lay.chunk_rows.shape[0] - 1,
                                    **sel)
                # (2) the local beams to the coordinator, ahead of the products.
                gathered = {key: send(beam_p[key], self._slots[key[0]][key[1]], coord)
                            for key in beam_p}
                # (3) the canonical merge == the global select for level li.
                with coord.enter():
                    w_ids, w_scores = _merge_beams(
                        [_cat_rows([gathered[pid, r][0] for r in range(len(rows))])
                         for pid in active],
                        [_cat_rows([gathered[pid, r][1] for r in range(len(rows))])
                         for pid in active],
                        width=width,
                    )
                # (4) speculative expansion of level li+1: the double buffer.
                if not is_last:
                    span *= idx.branching[li]
                    for pid in active:
                        for r, slot in enumerate(self._slots[pid]):
                            s_ids, s_sc = beam_p[pid, r]
                            with slot.enter():
                                spec_comb[pid, r], _ = self._level_owned(
                                    li + 1, pid, r, inputs, s_ids, s_sc, span, qt)
        return w_scores, w_ids

    def _run_partition(self, pid: int, r: int, ids_p, sc_p, xi_p, xv_p, *,
                       beam: Optional[int] = None, qt: Optional[int] = None):
        """One partition's whole-sub-tree traversal from the router beam (the
        final mode's and :meth:`profile`'s): the global beam localized (rows
        out of range to the phantom chunk, score ``NEG_INF``), then the
        continuation."""
        info = self.index.manifest.partitions[pid]
        c_real = info.chunk_end - info.chunk_start
        owned = (ids_p >= info.chunk_start) & (ids_p < info.chunk_end)
        local_ids = torch.where(owned, ids_p - info.chunk_start, c_real)
        local_sc = torch.where(owned, sc_p, NEG_INF)
        return self._trees[pid][r].infer(
            xi_p, xv_p,
            beam=self.beam if beam is None else beam, topk=self.topk,
            method=self.method, score_mode=self.score_mode,
            qt=self.qt if qt is None else qt,
            init_parent_ids=local_ids, init_scores=local_sc, clamp_chunks=True,
        )

    def _infer_final(self, x_idx, x_val, parent_ids, scores, active, *,
                     beam: int, qt: int):
        """Single-merge mode: whole sub-tree traversals, one canonical merge.
        Not bitwise the unpartitioned tree: each partition prunes locally,
        so the merged top-k dominates the exact one."""
        idx, coord = self.index, self._coord
        rows = row_slices(x_idx.shape[0], len(self._slots[0]))
        inputs = self._partition_inputs(x_idx, x_val, active, rows)
        width = reference_topk_width(idx.n_cols, idx.branching, beam, self.topk)
        out_s, out_l = [], []
        for pid in active:
            info, n_local = idx.manifest.partitions[pid], self._trees[pid][0].n_labels
            s_r, l_r = [], []
            for r, (slot, (r0, r1)) in enumerate(zip(self._slots[pid], rows)):
                ids_p, sc_p = send((parent_ids[r0:r1], scores[r0:r1]), coord, slot)
                xi_p, xv_p, _ = inputs[pid][r]
                with slot.enter():
                    s, l = self._run_partition(pid, r, ids_p, sc_p, xi_p, xv_p,
                                               beam=beam, qt=qt)
                    # Globalize: real leaves get the partition's label offset;
                    # local phantoms (id >= the local label count) go past
                    # every real global id, so they never win a tie.
                    gl = torch.where(l < n_local, l + info.label_start,
                                     idx.n_labels + info.label_start + l)
                s, gl = send((s, gl), slot, coord)
                s_r.append(s)
                l_r.append(gl)
            with coord.enter():
                out_s.append(_cat_rows(s_r))
                out_l.append(_cat_rows(l_r))
        with coord.enter():
            s_cat, l_cat = torch.cat(out_s, dim=1), torch.cat(out_l, dim=1)
            if s_cat.shape[1] < width:  # degenerate config; cannot fill the panel
                raise ValueError(
                    f"merged candidate width {s_cat.shape[1]} < reference width "
                    f"{width}; raise beam/topk or lower partitions"
                )
            return merge_topk(s_cat, l_cat, width=width)

    # -- diagnostics --------------------------------------------------------
    def cache_stats(self) -> Optional[dict]:
        """Hot-beam cache accounting, or None when the cache is off."""
        return self.cache.stats() if self.cache is not None else None

    def profile(self, x_idx: torch.Tensor, x_val: torch.Tensor) -> List[float]:
        """Blocking per-partition sub-tree latency (ms) for one batch: each
        partition's whole-sub-tree traversal (the ``"final"`` path) on its
        first slot, one after another, each waited for."""
        caller = Slot.current(x_idx.device)
        x_idx, x_val = send((x_idx, x_val), caller, self._coord)
        with self._coord.enter():
            scores, parent_ids = self._route(x_idx, x_val, beam=self.beam, qt=self.qt)
        _sync(self._coord)
        out = []
        for pid in range(self.index.n_partitions):
            slot = self._slots[pid][0]
            ids_p, sc_p, xi_p, xv_p = send((parent_ids, scores, x_idx, x_val),
                                           self._coord, slot)
            _sync(slot)
            t0 = time.perf_counter()
            with slot.enter():
                self._run_partition(pid, 0, ids_p, sc_p, xi_p, xv_p)
            _sync(slot)
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    def hit_counts(self, labels: np.ndarray) -> np.ndarray:
        """Per-partition share of a result set (occupancy accounting)."""
        return self.index.hit_counts(labels)


def _sync(slot: Slot) -> None:
    stream = slot.current_stream()
    if stream is not None:
        stream.synchronize()
