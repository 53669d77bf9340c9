"""An in-process :class:`~repro_torch.index.BeamTransport` for the tests:
the planner's own helpers serve every partition's half of the pipelined
exchange. Imports nothing of JAX, so card test files may use it too."""

import numpy as np
import torch

from repro_torch.core.tree import owned_level_combined
from repro_torch.index import BeamTransport, TransportDegraded
from repro_torch.index import planner as tplanner


class LocalTransport(BeamTransport):
    """Every partition's half of the pipelined exchange, in this process,
    through the planner's own helpers (the protocol a fleet worker serves).
    ``lose`` names a partition to drop at the first ``step`` of the first
    batch, as a serve_partial fleet would."""

    def __init__(self, index, *, beam=10, topk=5, method="mscm_dense", lose=None):
        self.index, self.beam, self.topk, self.method = index, beam, topk, method
        self.live = list(range(index.n_partitions))
        self.lose, self.begins = lose, 0

    @property
    def n_partitions(self):
        return self.index.n_partitions

    def down_partitions(self):
        return [p for p in range(self.n_partitions) if p not in self.live]

    def _owned(self, pid, li, ids, sc):
        from repro_torch.core.mscm import scatter_dense

        idx = self.index
        lay = idx.parts[pid].layers[li - idx.level]
        span = int(np.prod(idx.branching[idx.level:li], dtype=np.int64))
        xd = scatter_dense(self.xi, self.xv, idx.d)
        return owned_level_combined(
            lay, idx.branching[li], idx.d, self.xi, self.xv, xd, ids, sc,
            idx.manifest.partitions[pid].chunk_start * span, lay.chunk_rows.shape[0] - 1,
            method=self.method, score_mode="prod")

    def _sel(self, li):
        idx, last = self.index, li == len(self.index.n_cols) - 1
        return dict(n_cols=idx.n_cols[li], n_chunks=idx.n_cols[li - 1],
                    next_b=min(self.topk if last else self.beam, idx.n_cols[li]))

    def _speculate(self, pid, li, beam):
        if li + 1 < len(self.index.n_cols):
            self.spec[pid] = (beam[0], self._owned(pid, li + 1, *beam)[0])

    def begin(self, x_idx, x_val, parent_ids, scores, *, beam=None, qt=None):
        self.begins += 1
        self.xi, self.xv = torch.from_numpy(x_idx), torch.from_numpy(x_val)
        li, ids, sc = self.index.level, torch.from_numpy(parent_ids), torch.from_numpy(scores)
        self.spec, out = {}, []
        for pid in self.live:
            b = tplanner._local_select(ids, *self._owned(pid, li, ids, sc), **self._sel(li))
            self._speculate(pid, li, b)
            out.append((b[0].numpy(), b[1].numpy()))
        return out

    def step(self, level, winner_ids):
        if self.lose in self.live and self.begins == 1:
            self.live.remove(self.lose)
            raise TransportDegraded(self.lose, ConnectionError("worker lost"))
        idx, out = self.index, []
        for pid in self.live:
            lay = idx.parts[pid].layers[level - idx.level]
            span = int(np.prod(idx.branching[idx.level:level], dtype=np.int64))
            b = tplanner._reconcile_select(
                torch.from_numpy(winner_ids), *self.spec[pid],
                idx.manifest.partitions[pid].chunk_start * span,
                lay.chunk_rows.shape[0] - 1, **self._sel(level))
            self._speculate(pid, level, b)
            out.append((b[0].numpy(), b[1].numpy()))
        return out
