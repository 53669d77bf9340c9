"""MSCM tree head over the vocabulary — the paper's technique inside an LM.

Counterpart of ``repro.models.xmr_head``. A 2-level XMR tree over the vocab
(C = ceil(V/B) cluster rankers + the token rankers grouped in chunks of B)
replaces the dense lm_head at decode time:

    cluster scores   h · Wc            [N, C]        (small dense matmul)
    beam             top-b clusters
    token scores     masked blocks     [N, b, B]     (gather + einsum)

Decode cost drops from O(d·V) to O(d·C + b·d·B) per token. The chunk product
is a gather of the beam's chunks and one ``torch.einsum``, as the reference's
is (not a Pallas kernel there either).

The cluster beam takes ``lax.top_k``'s order: score descending, the lowest
cluster id first among ties (:func:`repro_torch.core.beam.topk_canonical`).

Construction is weight-exact: ``from_lm_head`` partitions the existing dense
head, so beam=C reproduces the full argmax exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.beam import topk_canonical
from repro_torch.models.common import dot, einsum


@dataclasses.dataclass
class VocabTreeHead:
    wc: torch.Tensor       # [d, C] cluster rankers (chunk centroids)
    chunks: torch.Tensor   # [C, d, B] token rankers, chunked by cluster
    n_vocab: int

    @property
    def branching(self) -> int:
        return self.chunks.shape[2]

    @property
    def n_clusters(self) -> int:
        return self.chunks.shape[0]

    @classmethod
    def from_lm_head(cls, head: torch.Tensor, branching: int = 128,
                     order: np.ndarray | None = None) -> "VocabTreeHead":
        """Partition a dense [d, V] head into a 2-level chunked tree, on the
        head's device.

        ``order`` optionally permutes the vocab (e.g. by embedding clustering)
        so chunk-mates are similar; identity keeps exactness testable.
        """
        d, v = head.shape
        b = int(branching)
        c = (v + b - 1) // b
        if order is not None:
            head = head[:, torch.as_tensor(np.asarray(order), device=head.device)]
        pad = c * b - v
        if pad:
            head = F.pad(head, (0, pad))
        chunks = head.reshape(d, c, b).permute(1, 0, 2).contiguous()   # [C, d, B]
        wc = chunks.mean(dim=2)                                         # [C, d] centroid
        return cls(wc=wc.T.contiguous(), chunks=chunks, n_vocab=v)

    def decode_logits(self, h: torch.Tensor, *, beam: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h [N, d] -> (scores [N, beam*B], token ids [N, beam*B]).

        Only beam·B of the V logits are computed (masked blocks)."""
        n, d = h.shape
        b = self.branching
        cscore = dot(h, self.wc)                                        # [N, C]
        clusters = torch.arange(self.n_clusters, device=h.device).expand(n, -1)
        top_i, _ = topk_canonical(cscore.float(), clusters, beam)       # [N, beam]
        # masked block evaluation: gather the beam's chunks, batched matmul
        sel = self.chunks[top_i]                                        # [N, beam, d, B]
        logits = einsum("nd,nkdb->nkb", h, sel)                         # [N, beam, B]
        ids = top_i[:, :, None] * b + torch.arange(b, device=h.device)[None, None]
        logits = torch.where(ids < self.n_vocab, logits, -torch.inf)
        return logits.reshape(n, -1), ids.reshape(n, -1)

    def full_logits(self, h: torch.Tensor) -> torch.Tensor:
        """Dense oracle (tests): all V logits."""
        w = self.chunks.permute(1, 0, 2).reshape(h.shape[1], -1)
        return dot(h, w)[:, : self.n_vocab]


def greedy_token(head: VocabTreeHead, h: torch.Tensor, beam: int = 8) -> torch.Tensor:
    scores, ids = head.decode_logits(h, beam=beam)
    best = torch.argmax(scores, dim=1)
    return ids.gather(1, best[:, None])[:, 0]
