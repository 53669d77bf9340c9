"""The work a traffic mix asks of a configuration, counted from shapes.

What the algorithm needs, not what the program launches or returns: a
change that stops reading something the algorithm does not need (the dense
``[n, d+1]`` query table, re-read tiles) shows as a gain against this
count, and a change of kernel leaves it as it is.

For one bucket of ``n`` queries (the engine serves a call in buckets of at
most ``max_batch``), at each level ``l`` with tiles ``(C, R, B)``:

- each query visits ``p_l`` chunks: 1 at the root, ``min(beam,
  n_cols[l-1])`` below it. Where this chip holds ``H`` of a level's ``C``
  chunks (one chip's share of a label-partitioned tree), it visits ``p_l *
  H / C`` of them on average: the traffic's targets are uniform over the
  labels and the tree is drawn alike everywhere, so no range of chunks is
  favoured;
- a query's visits are distinct chunks; the bucket's fall on ``D_l = H *
  (1 - (1 - q/H) ** n)`` distinct chunks, ``q = p_l * H / C``: the
  expected count where each query's visits fall on held chunks at random
  (``min(n * q, H)`` and below). Each is read once, at
  its stored size: ``R * B`` f32 values and ``R`` int32 row ids. A run
  logs this count beside the distinct chunks the reference's own beams
  visit;
- a (query, chunk) pair costs ``2 * R * B`` FLOPs.

Besides, each query's ``query_nnz`` ids and values are read once (8 bytes a
nonzero), and its ``topk`` results written once (an f32 score and an int32
label each).

The kernels' count is the same work as the kernels see it: per level, the
query's values at each visited chunk's rows (``blocks * R * 4``), the
distinct tiles (``D_l * R * B * 4``) and the block outputs (``blocks * B *
4``), with the same FLOPs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float = 0.0
    nbytes: float = 0.0          # the whole step's bytes
    kernel_bytes: float = 0.0    # the MSCM kernels' bytes

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.nbytes + other.nbytes,
                    self.kernel_bytes + other.kernel_bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.nbytes * k, self.kernel_bytes * k)


def chunks_per_query(n_cols: Sequence[int], beam: int) -> Tuple[int, ...]:
    """Chunks a query visits at each level: the root's one, then its beam."""
    return (1,) + tuple(min(beam, c) for c in n_cols[:-1])


def distinct_chunks(n: int, per_query: float, held: int) -> float:
    """Expected distinct chunks that ``n`` queries visit, each ``per_query``
    distinct chunks of ``held`` at random."""
    if per_query >= held:
        return float(held)
    return held * -math.expm1(n * math.log1p(-per_query / held))


def bucket_work(shapes: Sequence[Tuple[int, int, int]], n_cols: Sequence[int], n: int, *,
                beam: int, topk: int, query_nnz: int,
                held: Optional[Sequence[int]] = None) -> Work:
    """The work of one bucket of ``n`` queries over levels of tiles
    ``shapes`` = ``[(C, R, B), ...]``, of which this chip holds ``held[l]``
    chunks a level (all where None)."""
    flops = nbytes = kbytes = 0.0
    held = [c for c, _, _ in shapes] if held is None else held
    for (c, r, b), h, p in zip(shapes, held, chunks_per_query(n_cols, beam)):
        q = p * h / c
        blocks = n * q
        distinct = distinct_chunks(n, q, h)
        flops += 2.0 * r * b * blocks
        nbytes += distinct * r * (4.0 * b + 4.0)
        kbytes += blocks * r * 4.0 + distinct * r * b * 4.0 + blocks * b * 4.0
    nbytes += n * query_nnz * 8.0 + n * min(topk, n_cols[-1]) * 8.0
    return Work(flops, nbytes, kbytes)


def call_work(shapes, n_cols, n: int, *, max_batch: int, beam: int, topk: int,
              query_nnz: int, held: Optional[Sequence[int]] = None) -> Work:
    """The work of one call of ``n`` queries, served in buckets of at most
    ``max_batch``."""
    full, rest = divmod(n, max_batch)
    kw = dict(beam=beam, topk=topk, query_nnz=query_nnz, held=held)
    total = bucket_work(shapes, n_cols, max_batch, **kw) * full
    if rest:
        total = total + bucket_work(shapes, n_cols, rest, **kw)
    return total
