"""Enterprise XMR serving dry run: the paper's own deployment (§6) on the
production mesh (counterpart of ``repro.launch.serve_dryrun``).

The 100M-label, d = 4M semantic product-search model (tree [64, 32, 32, 32,
48] -> 100,663,296 leaves) served by the beam-search step sharded over the
``(data = 16, model = 16)`` mesh: queries split over ``"data"``, the leaf
level's chunks over ``"model"``, the upper levels replicated. The model
fits no single device (the leaf tiles are 154.6 GB in bf16, 309.2 GB in
f32); one device's shards are 13.6 GB.

Where the reference lowers and compiles the step on 512 placeholder host
devices and never runs it, the port runs it: on the ``meta`` production
mesh (:func:`repro_torch.launch.mesh.make_production_mesh`) for the record,
with every slot's program looped over as ``core/distributed.py``'s
``sharded_infer`` loops (a stream a slot on a card), and, on a card, one
device's program at full geometry (``chip_smoke.py``'s enterprise phase,
from the shards :func:`make_upper`, :func:`make_leaf_shard` and
:func:`make_queries` draw there). Like the reference it runs the dense
lookup and plain ops, no kernel.

The record keeps the reference's keys where the port can fill them:
``memory.argument_gb_per_device`` from the shapes and specs (XLA's memory
analysis in the reference), ``roofline`` from :mod:`repro_torch.launch.hw`
over the FLOPs and bytes that :class:`~repro_torch.launch.hlo_stats.
OpCounter` counts as the slots' programs run (XLA's ``cost_analysis``), and
``collectives``: the candidate hand-offs that ``send`` moves between
distinct slots (the reference's two ``all_gather``\\s). ``temp_gb_per_device``
has no counterpart: the record says so.

    PYTHONPATH=src python -m repro_torch.launch.serve_dryrun [--batch 1024] [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mscm as mscm_lib
from repro_torch.core.beam import NEG_INF, beam_step, topk_canonical
from repro_torch.distributed.sharding import (
    DeviceMesh, NamedSharding, P, Slot, axis_size, record_sends, send)
from repro_torch.launch import hw
from repro_torch.launch.hlo_stats import OpCounter, send_stats
from repro_torch.launch.mesh import argument_bytes, make_production_mesh


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A tree's shape: feature dim, branching per level, nonzeros a column
    of the pruned rankers, chunk rows (ELL width) and query nonzeros."""

    d_feat: int
    branching: Tuple[int, ...]
    level_nnz: int
    ell_r: int
    query_nnz: int

    def level_sizes(self) -> List[int]:
        out, n = [], 1
        for b in self.branching:
            n *= b
            out.append(n)
        return out

    def level_shapes(self) -> List[Tuple[int, int, int]]:
        """(chunks C, rows R, columns B) of each level's tiles."""
        sizes = self.level_sizes()
        out = []
        for li, b in enumerate(self.branching):
            c = sizes[li - 1] if li else 1
            r = min(self.ell_r, ((self.level_nnz * b + 7) // 8) * 8) if li == 0 else self.ell_r
            out.append((c, r, b))
        return out


# enterprise tree geometry (paper §6: L = 100M, d = 4M, branching 32-ish)
ENTERPRISE = Geometry(d_feat=4_000_000, branching=(64, 32, 32, 32, 48), level_nnz=64,
                      ell_r=768, query_nnz=256)
D_FEAT = ENTERPRISE.d_feat
BRANCHING = list(ENTERPRISE.branching)    # level sizes 64 ... 100,663,296
LEVEL_NNZ = ENTERPRISE.level_nnz          # pruned ranker nnz per column
ELL_R = ENTERPRISE.ell_r                  # chunk union rows (64 nnz x B overlap)
QUERY_NNZ = ENTERPRISE.query_nnz

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def level_sizes(geom: Geometry = ENTERPRISE) -> List[int]:
    return geom.level_sizes()


def serve_step_spec(batch: int, beam: int, topk: int, mesh: DeviceMesh,
                    geom: Geometry = ENTERPRISE):
    """``(serve, specs, shardings)``: the step, its arguments as ``meta``
    tensors of their global shapes (queries ``xi`` int32 and ``xv`` f32
    [batch, query_nnz], then each level's rows int32 [C, R] and bf16 values
    [C, R, B]), and a :class:`NamedSharding` each. ``serve(*args)`` places
    the arguments on the mesh's slots and runs every slot's program;
    it returns, per data block, ``(home slot, scores [n, topk], leaf ids
    [n, topk] int32)``, the block's merged top-k on its model slot 0."""
    q = NamedSharding(mesh, P("data", None))
    specs = [torch.empty((batch, geom.query_nnz), dtype=torch.int32, device="meta"),
             torch.empty((batch, geom.query_nnz), dtype=torch.float32, device="meta")]
    shardings = [q, q]
    shapes = geom.level_shapes()
    for li, (c, r, b) in enumerate(shapes):
        leaf = li == len(shapes) - 1
        specs += [torch.empty((c, r), dtype=torch.int32, device="meta"),
                  torch.empty((c, r, b), dtype=torch.bfloat16, device="meta")]
        shardings += [NamedSharding(mesh, P("model", None) if leaf else P()),
                      NamedSharding(mesh, P("model", None, None) if leaf else P())]

    def serve(*args):
        return run_on_mesh(place(args, shardings, mesh), mesh, geom, beam=beam, topk=topk)

    return serve, specs, shardings


def _block(t: torch.Tensor, spec, mesh: DeviceMesh, coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``t`` that the slot at mesh ``coords`` holds under
    ``spec`` (a view)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        i = 0
        for a in axes:  # row-major over the dim's mesh axes
            i = i * mesh.shape[a] + coords[a]
        size = -(-t.shape[dim] // axis_size(mesh, axes))
        t = t.narrow(dim, i * size, max(0, min(size, t.shape[dim] - i * size)))
    return t


def place(args: Sequence[torch.Tensor], shardings: Sequence[NamedSharding],
          mesh: DeviceMesh) -> np.ndarray:
    """Each slot's blocks of ``args``, on the slot's device: an object array
    shaped like the mesh of argument tuples. One copy a distinct (block,
    device); on the device the arguments already live on, views."""
    placed = np.empty(mesh.devices.shape, dtype=object)
    copies: Dict[Tuple, torch.Tensor] = {}
    for idx in np.ndindex(mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, idx))
        dev = mesh.devices[idx]
        per = []
        for a, sh in zip(args, shardings):
            blk = _block(a, sh.spec, mesh, coords)
            key = (id(a), blk.storage_offset(), tuple(blk.shape), str(dev))
            if key not in copies:
                copies[key] = blk.to(dev)
            per.append(copies[key])
        placed[idx] = tuple(per)
    return placed


def _top_k(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """``lax.top_k``'s order over a row (score descending, the lower
    position first among ties) -> (scores [n, k], ids [n, k])."""
    pos = torch.arange(scores.shape[1], device=scores.device).expand(scores.shape[0], -1)
    top_pos, top_s = topk_canonical(scores, pos, k)
    return top_s, ids.gather(1, top_pos)


def upper_beam(xd: torch.Tensor, *upper: torch.Tensor, geom: Geometry = ENTERPRISE,
               beam: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """The beam down the replicated upper levels (``upper``: each level's
    rows and values, flat) for the queries of the dense table ``xd``:
    (leaf-level parents int64 [n, b], their scores f32 [n, b]), in the
    canonical order of ``beam_step``."""
    sizes = geom.level_sizes()
    n, dev = xd.shape[0], xd.device
    parent = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    scores = torch.ones((n, 1), dtype=torch.float32, device=dev)
    for li in range(len(upper) // 2):
        rows_l, vals_l = upper[2 * li], upper[2 * li + 1]
        bc = parent.shape[1]
        bq = torch.arange(n, device=dev).repeat_interleave(bc)
        logits = mscm_lib.mscm_dense_lookup(
            xd, rows_l, vals_l, bq, parent.reshape(-1)).reshape(n, bc, geom.branching[li])
        parent, scores = beam_step(parent, scores, logits, sizes[li], min(beam, sizes[li]))
    return parent, scores


def leaf_topk(xd: torch.Tensor, parent: torch.Tensor, scores: torch.Tensor,
              leaf_rows: torch.Tensor, leaf_vals: torch.Tensor, *, m: int,
              geom: Geometry = ENTERPRISE, topk: int = 10):
    """Model slot ``m``'s local top-k: the leaf blocks of the beam that its
    shard (``leaf_rows``, ``leaf_vals``: a contiguous range of chunks)
    owns, the others ``NEG_INF``. Returns (scores f32 [n, topk], leaf ids
    int32 [n, topk]) in ``lax.top_k``'s order."""
    n, dev = xd.shape[0], xd.device
    c_local = leaf_vals.shape[0]
    b = geom.branching[-1]
    bc = parent.shape[1]
    bq = torch.arange(n, device=dev).repeat_interleave(bc)
    fp = parent.reshape(-1)
    local_c = (fp - m * c_local).clamp(0, c_local - 1)
    logits = mscm_lib.mscm_dense_lookup(xd, leaf_rows, leaf_vals, bq, local_c).reshape(n, bc, b)
    mine = ((fp // c_local) == m).reshape(n, bc, 1)
    child = fp.reshape(n, bc, 1) * b + torch.arange(b, device=dev)
    # No child < n_cols mask: the enterprise tree is full, as in the reference.
    comb = torch.where(mine, torch.sigmoid(logits) * scores[..., None], NEG_INF)
    ls, li = _top_k(comb.reshape(n, -1), child.reshape(n, -1), topk)
    return ls, li.to(torch.int32)


def device_step(xi: torch.Tensor, xv: torch.Tensor, *layers: torch.Tensor, m: int,
                geom: Geometry = ENTERPRISE, beam: int = 10, topk: int = 10):
    """One device's program (the reference's per-device ``run`` body): its
    queries scattered into the dense table, down the replicated upper
    levels (:func:`upper_beam`), then the leaf blocks that model slot ``m``
    owns (:func:`leaf_topk`). ``layers`` are each level's (rows, values),
    the leaf's this slot's shard. Returns (scores f32 [n, topk], leaf ids
    int32 [n, topk])."""
    xd = mscm_lib.scatter_dense(xi, xv, geom.d_feat)
    parent, scores = upper_beam(xd, *layers[:-2], geom=geom, beam=beam)
    return leaf_topk(xd, parent, scores, *layers[-2:], m=m, geom=geom, topk=topk)


def merge_candidates(scores: Sequence[torch.Tensor], ids: Sequence[torch.Tensor], topk: int):
    """The global top-k over the model slots' candidates, gathered in model
    slot order (the reference's ``all_gather`` on ``axis=1``), in
    ``lax.top_k``'s order."""
    return _top_k(torch.cat(list(scores), dim=1), torch.cat(list(ids), dim=1), topk)


def run_on_mesh(placed: np.ndarray, mesh: DeviceMesh, geom: Geometry = ENTERPRISE, *,
                beam: int = 10, topk: int = 10) -> List[Tuple[Slot, torch.Tensor, torch.Tensor]]:
    """Every slot's :func:`device_step` on its own slot (a stream of its own
    on a card), then each data block's candidates handed to its model slot
    0 (:func:`send`) and merged there. The queries are split over
    ``"data"`` only, so across pods the blocks repeat: the first pod's are
    returned, in data order."""
    names = mesh.axis_names
    ax_model, ax_data = names.index("model"), names.index("data")
    out: Dict[int, Tuple[Slot, torch.Tensor, torch.Tensor]] = {}
    shape = mesh.devices.shape
    rows = [i for i in np.ndindex(shape) if i[ax_model] == 0]
    for row in rows:
        slots, cands = [], []
        for m in range(shape[ax_model]):
            idx = row[:ax_model] + (m,) + row[ax_model + 1:]
            slot = Slot.new(mesh.devices[idx])
            with slot.enter():
                cands.append(device_step(*placed[idx], m=m, geom=geom, beam=beam, topk=topk))
            slots.append(slot)
        home = slots[0]
        got = [send(c, s, home) for s, c in zip(slots, cands)]
        with home.enter():
            s, i = merge_candidates([g[0] for g in got], [g[1] for g in got], topk)
        out.setdefault(row[ax_data], (home, s, i))
    return [out[k] for k in sorted(out)]


def collect(blocks, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data blocks' results, in order, on ``device`` (the caller's
    stream there): ``(scores [batch, topk], ids [batch, topk])``."""
    caller = Slot.current(device)
    got = [send((s, i), home, caller) for home, s, i in blocks]
    return torch.cat([g[0] for g in got]), torch.cat([g[1] for g in got])


# ---------------------------------------------------------------------------
# one device's shards, drawn on the device
# ---------------------------------------------------------------------------

def _feature_ids(shape, d: int, generator: torch.Generator, device) -> torch.Tensor:
    """int32 feature ids in ``[0, d]``, skewed toward the low ids as a
    Zipf-like vocabulary is (``floor((d + 1) u^3)``): a query then meets
    ~10 rows of a 768-row chunk. Uniform ids would meet ~0.05 and leave
    almost every logit at exactly 0."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u.pow_(3).mul_(d + 1)).to(torch.int64).clamp_(max=d).to(torch.int32)


def make_level(c: int, r: int, b: int, geom: Geometry, seed: int, device,
               rows_per_draw: int = 1 << 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's (rows int32 [c, r], values bf16 [c, r, b] ~ N(0, 1)),
    drawn on ``device`` from a generator seeded with ``seed``; the rows in
    draws of ``rows_per_draw`` chunks, to bound the f32 temporaries."""
    g = torch.Generator(device).manual_seed(seed)
    vals = torch.randn((c, r, b), generator=g, device=device, dtype=torch.bfloat16)
    rows = torch.empty((c, r), dtype=torch.int32, device=device)
    for c0 in range(0, c, rows_per_draw):
        c1 = min(c, c0 + rows_per_draw)
        rows[c0:c1] = _feature_ids((c1 - c0, r), geom.d_feat, g, device)
    return rows, vals


def make_upper(geom: Geometry = ENTERPRISE, *, device, seed: int = 0) -> List[torch.Tensor]:
    """The replicated upper levels, flat ``[rows0, vals0, rows1, ...]``,
    level ``li`` seeded ``seed + li``."""
    out: List[torch.Tensor] = []
    for li, (c, r, b) in enumerate(geom.level_shapes()[:-1]):
        out += make_level(c, r, b, geom, seed + li, device)
    return out


def make_leaf_shard(m: int, n_model: int, geom: Geometry = ENTERPRISE, *, device,
                    seed: int = 0) -> List[torch.Tensor]:
    """Model slot ``m``'s block of the leaf level, ``[rows, vals]``, seeded
    ``seed + 100 + m``."""
    c, r, b = geom.level_shapes()[-1]
    if c % n_model:
        raise ValueError(f"{c} leaf chunks do not split over {n_model} model slots")
    return list(make_level(c // n_model, r, b, geom, seed + 100 + m, device))


def make_queries(n: int, block: int, geom: Geometry = ENTERPRISE, *, device,
                 seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data block ``block``'s ``n`` queries: ``query_nnz`` skewed feature ids
    (int32) and values in [0, 1) (f32), seeded ``seed + 1000 + block``."""
    g = torch.Generator(device).manual_seed(seed + 1000 + block)
    xi = _feature_ids((n, geom.query_nnz), geom.d_feat - 1, g, device)
    xv = torch.rand((n, geom.query_nnz), generator=g, device=device)
    return xi, xv


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def dry_run(batch: int = 1024, beam: int = 10, topk: int = 10, *, multi_pod: bool = False,
            geom: Geometry = ENTERPRISE) -> dict:
    """Run the step on the ``meta`` production mesh; the record."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.devices.size
    fn, specs, shardings = serve_step_spec(batch, beam, topk, mesh, geom)
    arg_bytes = argument_bytes(specs, shardings)
    n_local = -(-batch // mesh.shape["data"])
    t0 = time.time()
    with OpCounter() as counter, record_sends() as log:
        fn(*specs)
    run_s = time.time() - t0
    coll = send_stats(log)
    cb = coll["TOTAL"]["operand_bytes"]
    terms = hw.roofline_terms(flops=counter.flops, bytes_hbm=counter.bytes,
                              bytes_collective=cb, chips=chips)
    sizes = geom.level_sizes()
    return {
        "model": f"enterprise L={sizes[-1]:,} d={geom.d_feat:,} tree={list(geom.branching)}",
        "batch": batch, "beam": beam, "chips": chips,
        "meta_run_s": round(run_s, 2),
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "argument_gb_per_device": arg_bytes / 1e9,
            "dense_table_gb_per_device": n_local * (geom.d_feat + 1) * 4 / 1e9,
            "temp_gb_per_device": None,
            "temp_note": ("XLA's memory analysis of the compiled program; the port "
                          "compiles none (the dense query table is the largest "
                          "temporary: dense_table_gb_per_device)"),
        },
        "counted_flops": counter.flops,
        "counted_bytes": counter.bytes,
        "counted_flops_per_device": counter.flops / chips,
        "counted_bytes_per_device": counter.bytes / chips,
        "roofline": terms,
        "per_query_bound_us": 1e6 * terms["bound_s"] / batch,
        "collectives": coll,
        "top_ops": counter.top(6),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--beam", type=int, default=10)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()

    rec = dry_run(args.batch, args.beam, args.topk, multi_pod=args.multi_pod)
    print(json.dumps(rec, indent=1))
    out = os.path.join(OUT_DIR, f"enterprise__serve__{'multi' if args.multi_pod else 'single'}"
                                ".json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
