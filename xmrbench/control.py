"""What the check has to catch: the control, and the faults a serving cell
can have.

The control is the reference put in the engine's place and computed a
step below the configuration's float32: tiles and query values rounded to
bfloat16, the arithmetic in float32 (the step a later change storing the
tiles in bf16 would take). A fault wraps the real engine and breaks what
it hands back: ``alter_answer`` changes every query's best label where
the answer is produced; ``drop_half`` serves the first half of each call
and hands its answers back for the second half too; ``stale`` returns the
first answer it computed for every later call, its state never updated.
"""

from __future__ import annotations

import numpy as np
import torch

from xmrbench import reference

FAULTS = ("alter_answer", "drop_half", "stale")
#: The score the program gives a slot that no held candidate fills.
EMPTY = -1e30


class Control:
    def __init__(self, levels, geom, serve: dict, device, value_dtype=torch.bfloat16):
        self.levels, self.geom, self.serve = levels, geom, serve
        self.device, self.value_dtype = torch.device(device), value_dtype

    def warmup(self, d, batch_sizes=(1,)) -> None:
        pass

    def serve_batch(self, csr):
        n = csr.shape[0]
        ids = torch.from_numpy(csr.indices.reshape(n, -1)).to(self.device)
        vals = torch.from_numpy(csr.data.reshape(n, -1)).to(self.device)
        s, l = reference.search(self.levels, self.geom.n_cols, self.geom.branching, ids, vals,
                                beam=self.serve["beam"], topk=self.serve["topk"],
                                value_dtype=self.value_dtype)
        # An empty slot as the program marks it.
        s = torch.where(s == -torch.inf, EMPTY, s)
        return s.float().cpu().numpy(), l.cpu().numpy()

    serve_online = serve_batch


class Fault:
    def __init__(self, engine, kind: str, n_labels: int):
        if kind not in FAULTS:
            raise ValueError(f"unknown fault {kind!r}")
        self.engine, self.kind, self.n_labels = engine, kind, n_labels
        self._first = None

    def warmup(self, d, batch_sizes=(1,)) -> None:
        self.engine.warmup(d, batch_sizes=batch_sizes)

    def serve_batch(self, csr):
        return self._serve(self.engine.serve_batch, csr)

    def serve_online(self, csr):
        return self._serve(self.engine.serve_online, csr)

    def _serve(self, fn, csr):
        n = csr.shape[0]
        if self.kind == "stale":
            if self._first is None or len(self._first[0]) != n:
                self._first = fn(csr)
            return self._first
        if self.kind == "drop_half" and n > 1:
            h = (n + 1) // 2
            end = csr.indptr[h]
            half = type(csr)(csr.indptr[:h + 1], csr.indices[:end], csr.data[:end],
                             (h, csr.shape[1]))
            s, l = fn(half)
            return np.concatenate([s, s])[:n], np.concatenate([l, l])[:n]
        s, l = fn(csr)
        if self.kind == "alter_answer":
            l = l.copy()
            l[:, 0] = (l[:, 0] + self.n_labels // 2) % self.n_labels
        return s, l


def control_hook(value_dtype=torch.bfloat16):
    def hook(engine, levels, geom, serve):
        return Control(levels, geom, serve, engine.device, value_dtype)
    return hook


def fault_hook(kind: str):
    def hook(engine, levels, geom, serve):
        return Fault(engine, kind, geom.n_labels)
    return hook
