"""The benchmark's inputs, made on the device from the seed.

A configuration's tree and a traffic mix's query pool. The same seed gives
the same tensors on the same kind of device. Everything is drawn with
``torch.Generator`` in a few large calls per block of chunks; nothing is
built on the host.

The tree. Level ``l`` has ``C`` chunks of ``B`` sibling columns over ``R``
rows (``C`` = the previous level's column count, 1 at the root). Each
chunk's rows are sorted and distinct: row ``r`` is drawn from the ``r``-th
of ``R`` equal strata of ``[0, d)``. Each column holds ``K = min(col_nnz,
R)`` nonzeros, N(0, 1) as ``data/build.py`` draws them: its ``k``-th sits at
a row drawn from the ``k``-th of ``K`` equal strata of the chunk's rows.
Columns past the level's true count (``n_cols``) hold none. The column
layout (``col_rows``, ``col_vals``: each column's rows and values, ``[C *
B, K]``, the sentinel ``d`` and 0 on empty columns) holds the same
nonzeros as the tiles.

One chip's share. Where the configuration names ``leaf_chunks = [c0,
c1)``, the last level holds only those chunks (local chunk ``i`` is global
chunk ``c0 + i``) and one spare chunk after them: rows all ``d``, no
nonzeros, the layout in which a label partition parks the beam entries it
does not own. The levels above are whole.

The pool, synthetic. Each query targets a leaf, uniform over all the true
labels. ``path_share`` of its ``query_nnz`` nonzeros come from the nonzero
rows of the target's ancestor columns, split evenly over the levels, rows
where that column weighs positive first; a leaf column that this chip does
not hold gives ids drawn one in each of equal strata of ``[0, d)``, as its
rows are spread. The rest fall one in each of equal strata of ``[0, d)``.
Values are |N(0, 1)| + 0.1. Ids are sorted and distinct within a query.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: Elements of ``[C, R, B]`` tile a generation block covers (a fixed
#: constant: the blocks, and so the random streams, depend on shapes only).
BLOCK_ELEMS = 1 << 25


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one part of the inputs, from the run's seed and a tag."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:7], "little")


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(sub_seed(seed, tag))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A configuration's tree: feature dim, branching and true column count
    per level, chunk rows per level, nonzeros a column and a query, and the
    last level's chunks this chip holds (None: all)."""

    d: int
    branching: Tuple[int, ...]
    n_cols: Tuple[int, ...]
    chunk_rows: Tuple[int, ...]
    col_nnz: int
    query_nnz: int
    leaf_chunks: Optional[Tuple[int, int]] = None

    @classmethod
    def of(cls, cfg: dict) -> "Geometry":
        held = cfg.get("leaf_chunks")
        g = cls(int(cfg["d"]), tuple(cfg["branching"]), tuple(cfg["n_cols"]),
                tuple(cfg["chunk_rows"]), int(cfg["col_nnz"]), int(cfg["query_nnz"]),
                None if held is None else (int(held[0]), int(held[1])))
        g.check()
        return g

    def shapes(self) -> List[Tuple[int, int, int]]:
        """``(C, R, B)`` of each level's tiles, the whole tree's."""
        chunks = (1,) + self.n_cols[:-1]
        return list(zip(chunks, self.chunk_rows, self.branching))

    def held(self, li: int) -> Tuple[int, int]:
        """The chunk range ``[c0, c1)`` of level ``li`` that this chip holds."""
        if li == len(self.branching) - 1 and self.leaf_chunks is not None:
            return self.leaf_chunks
        return 0, self.shapes()[li][0]

    def check(self) -> None:
        depth = len(self.branching)
        if not (len(self.n_cols) == len(self.chunk_rows) == depth >= 1):
            raise ValueError("branching, n_cols and chunk_rows need one entry a level")
        for (c, r, b), n in zip(self.shapes(), self.n_cols):
            if not (c - 1) * b < n <= c * b:
                raise ValueError(f"{n} columns do not fill {c} chunks of {b}")
            if not 1 <= r <= self.d:
                raise ValueError(f"chunk rows {r} outside [1, d = {self.d}]")
        c0, c1 = self.held(depth - 1)
        if not 0 <= c0 < c1 <= self.shapes()[-1][0]:
            raise ValueError(f"leaf chunks [{c0}, {c1}) outside the last level's")
        if self.query_nnz > self.d:
            raise ValueError("query_nnz exceeds d")

    @property
    def n_labels(self) -> int:
        return self.n_cols[-1]


@dataclasses.dataclass
class Level:
    """One level as held: ``C`` = the held chunks, plus the spare one where
    the range is not the whole level."""

    chunk_rows: torch.Tensor  # int32 [C, R]
    chunk_vals: torch.Tensor  # f32 [C, R, B]
    col_rows: torch.Tensor    # int32 [C * B, K]
    col_vals: torch.Tensor    # f32 [C * B, K]
    held: Tuple[int, int]     # the global chunk range [c0, c1) of chunks 0 .. c1 - c0 - 1


def _strata(n: int, total: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Starts and widths of ``n`` equal integer strata of ``[0, total)``."""
    i = torch.arange(n + 1, device=device, dtype=torch.int64)
    edges = i * total // n
    return edges[:-1], edges[1:] - edges[:-1]


def _draw(lo: torch.Tensor, width: torch.Tensor, shape, g: torch.Generator) -> torch.Tensor:
    """One integer from each stratum (broadcast over ``shape``'s leading dims)."""
    u = torch.rand(shape, generator=g, device=lo.device, dtype=torch.float64)
    off = torch.minimum((u * width).to(torch.int64), width - 1)
    return lo + off


def make_level(geom: Geometry, li: int, seed: int, device) -> Level:
    _, r, b = geom.shapes()[li]
    first, end = geom.held(li)
    c = end - first
    spare = int(c < geom.shapes()[li][0])
    n = geom.n_cols[li]
    k = min(geom.col_nnz, r)
    dev = torch.device(device)
    g = generator(dev, seed, f"tree/{li}")
    row_lo, row_w = _strata(r, geom.d, dev)
    pos_lo, pos_w = _strata(k, r, dev)
    rows = torch.full((c + spare, r), geom.d, dtype=torch.int32, device=dev)
    vals = torch.zeros((c + spare, r, b), dtype=torch.float32, device=dev)
    col_rows = torch.full(((c + spare) * b, k), geom.d, dtype=torch.int32, device=dev)
    col_vals = torch.zeros(((c + spare) * b, k), dtype=torch.float32, device=dev)
    step = max(1, BLOCK_ELEMS // (r * b))
    within = torch.arange(b, device=dev)
    for c0 in range(0, c, step):
        c1 = min(c, c0 + step)
        cb = c1 - c0
        blk_rows = _draw(row_lo, row_w, (cb, r), g)                   # [cb, R]
        pos = _draw(pos_lo, pos_w, (cb, b, k), g)                     # [cb, B, K]
        v = torch.randn((cb, b, k), generator=g, device=dev)
        glob = torch.arange(first + c0, first + c1, device=dev)[:, None]
        live = (glob * b + within) < n                                 # [cb, B]
        v = torch.where(live[..., None], v, 0.0)
        rows[c0:c1] = blk_rows.to(torch.int32)
        flat = (pos * b + within[None, :, None]).reshape(cb, b * k)
        vals[c0:c1].view(cb, r * b).scatter_(1, flat, v.reshape(cb, b * k))
        cr = blk_rows.gather(1, pos.reshape(cb, b * k)).reshape(cb, b, k)
        cr = torch.where(live[..., None], cr, geom.d)
        col_rows[c0 * b:c1 * b] = cr.reshape(cb * b, k).to(torch.int32)
        col_vals[c0 * b:c1 * b] = v.reshape(cb * b, k)
    return Level(rows, vals, col_rows, col_vals, (first, end))


def make_tree(geom: Geometry, seed: int, device) -> List[Level]:
    return [make_level(geom, li, seed, device) for li in range(len(geom.branching))]


def checksum(levels: Sequence[Level]) -> List[Tuple[float, int]]:
    """Per level, the f64 sum of the tiles and the sum of their row ids: read
    again after the window, they show whether anything wrote into the
    benchmark's tensors."""
    return [(float(l.chunk_vals.sum(dtype=torch.float64)),
             int(l.chunk_rows.sum(dtype=torch.int64))) for l in levels]


def _targets(n: int, n_labels: int, dist: dict, g: torch.Generator, dev) -> torch.Tensor:
    kind = dist.get("dist", "uniform")
    if kind != "uniform":
        raise ValueError(f"unknown target distribution {kind!r}")
    return torch.randint(0, n_labels, (n,), generator=g, device=dev)


@dataclasses.dataclass
class Pool:
    """Queries on the host: ``ids`` int32 and ``vals`` f32, ``[n, Q]``, ids
    sorted and distinct within a row; ``targets`` the leaf each query was
    drawn along."""

    ids: np.ndarray
    vals: np.ndarray
    targets: np.ndarray

    def __len__(self) -> int:
        return self.ids.shape[0]

    def rows(self, start: int, count: int) -> np.ndarray:
        """Pool rows ``start, start + 1, ...`` (wrapping), ``count`` of them."""
        return (start + np.arange(count)) % len(self)


def make_pool(geom: Geometry, levels: Sequence[Level], mix: dict, n: int, seed: int,
              device) -> Pool:
    dev = torch.device(device)
    g = generator(dev, seed, "pool")
    q = geom.query_nnz
    n_path = int(round(float(mix["path_share"]) * q))
    depth = len(levels)
    per_level = [n_path // depth + (li < n_path % depth) for li in range(depth)]
    targets = _targets(n, geom.n_labels, mix.get("targets", {}), g, dev)
    parts = []
    node = targets
    for li in reversed(range(depth)):
        lev, k, b = levels[li], per_level[li], geom.branching[li]
        if k:
            first, end = lev.held
            local = node - first * b
            held = (local >= 0) & (local < (end - first) * b)
            col = torch.where(held, local, 0)
            cr = lev.col_rows[col].to(torch.int64)                    # [n, K]
            key = torch.rand(cr.shape, generator=g, device=dev) + (lev.col_vals[col] > 0)
            ids = cr.gather(1, key.topk(k, dim=1).indices)
            if (first, end) != (0, geom.shapes()[li][0]):
                lo, w = _strata(k, geom.d, dev)
                ids = torch.where(held[:, None], ids, _draw(lo, w, (n, k), g))
            parts.append(ids)
        node = node // b
    n_uni = q - n_path
    if n_uni:
        lo, w = _strata(n_uni, geom.d, dev)
        parts.append(_draw(lo, w, (n, n_uni), g))
    ids = torch.cat(parts, dim=1)
    vals = torch.randn(ids.shape, generator=g, device=dev).abs_() + 0.1
    while True:
        ids, order = torch.sort(ids, dim=1)
        vals = vals.gather(1, order)
        dup = torch.zeros_like(ids, dtype=torch.bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        n_dup = int(dup.sum())
        if not n_dup:
            break
        ids[dup] = torch.randint(0, geom.d, (n_dup,), generator=g, device=dev)
    return Pool(ids.to(torch.int32).cpu().numpy(), vals.cpu().numpy(),
                targets.cpu().numpy())
