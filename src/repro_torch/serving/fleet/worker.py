"""Fleet partition worker: one process, one label partition (counterpart of
``repro.serving.fleet.worker``).

Run as ``python -m repro_torch.serving.fleet.worker --host 127.0.0.1
--port 0 [--device cuda:0]``. The worker binds (port 0 = ephemeral), prints
one JSON line with the bound port and its pid on stdout, then serves
length-prefixed RPC frames (:mod:`repro_torch.serving.fleet.rpc`) until a
``shutdown`` op. Its partition lives on ``--device``: the card unless the
CPU is named (:func:`~repro_torch.core.tree.resolve_device`).

Ops:

``ping``
    liveness probe; replies at once.
``load``
    receive one partition's sliced layer tensors and the global tree
    metadata, and build the local :class:`~repro_torch.core.tree.XMRTree`
    (or :class:`~repro_torch.quant.storage.QuantizedTree`) on the device.
``begin`` / ``step``
    the partition half of the pipelined exchange protocol (see
    :class:`~repro_torch.index.planner.BeamTransport`), run by
    :class:`PartitionRunner` through the helpers the in-process planner
    uses (:func:`~repro_torch.core.tree.owned_level_combined`,
    ``_local_select``, ``_reconcile_select``): the same arithmetic on the
    same shapes, so fleet-served results are bitwise in-process serving.
``shutdown``
    reply, then exit.

What a reply waits for: ``begin`` and ``step`` enqueue the cheap local
select, then the copy of its small ``[n, w]`` beam to pinned host memory
and an event behind it, then the *speculative* next-level product; only
then does the worker wait, on that event alone, and write the reply. The
heavy product keeps running on the card while the coordinator merges the
beams (``tensor.cpu()`` would wait for the whole stream, speculation
included). On the CPU everything has finished when the call returns.
"""

from __future__ import annotations

# xmrlint: single-threaded — one accept loop, one connection, no concurrent
# frame writers on this socket; the coordinator side carries the lock.
import argparse
import json
import os
import signal
import socket
import struct
import sys
import traceback
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mscm import scatter_dense
from repro_torch.core.tree import (
    _NEEDS_DENSE, TreeLayerArrays, XMRTree, owned_level_combined, resolve_device)
from repro_torch.index.planner import _local_select, _reconcile_select
from repro_torch.serving.fleet.rpc import recv_frame, send_frame


def _tensor(a, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array on ``device``. Read-only or strided arrays (a caller's
    views, e.g. a payload built in process) are copied first."""
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a).to(device, dtype)


class PartitionRunner:
    """One partition's half of the pipelined beam-exchange protocol, on
    ``device`` (the card unless named)."""

    def __init__(
        self,
        header: dict,
        arrays: List[np.ndarray],
        *,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.pid = int(header["pid"])
        self.level = int(header["level"])          # split level li0
        self.n_cols = tuple(header["n_cols"])      # GLOBAL per-level counts
        self.branching = tuple(header["branching"])
        self.chunk_start = int(header["chunk_start"])
        self.beam = int(header["beam"])
        self.topk = int(header["topk"])
        self.method = str(header["method"])
        self.score_mode = str(header["score_mode"])
        self.qt = int(header["qt"])
        self.tier = str(header.get("tier", "exact"))
        d = int(header["d"])
        t = [_tensor(a, self.device) for a in arrays]
        geometry = dict(n_cols=tuple(header["part_n_cols"]),
                        branching=self.branching[self.level:], d=d)
        if self.tier != "exact":
            # Quantized payload: three tensors a layer (exact mask, int8
            # weights, f32 scale rows), see ``partition_payload``.
            from repro_torch.quant.storage import QuantizedTree, QuantLayerArrays

            self.part = QuantizedTree(
                layers=[QuantLayerArrays(*t[i:i + 3]) for i in range(0, len(t), 3)],
                tier=self.tier, **geometry)
        else:
            self.part = XMRTree(
                layers=[TreeLayerArrays(*t[i:i + 4]) for i in range(0, len(t), 4)],
                **geometry)
        # Per-batch state. The effective beam/qt default to the loaded
        # settings; begin() may narrow them for one batch (adaptive beam
        # tiers are the coordinator's choice, the worker obeys).
        self._beam = self.beam
        self._qt = self.qt
        self._xi = self._xv = self._xd = None
        self._spec_ids = self._spec_comb = None

    @property
    def depth(self) -> int:
        return len(self.n_cols)

    def _span(self, li: int) -> int:
        """Branching product between the split level and ``li``."""
        return int(np.prod(self.branching[self.level:li], dtype=np.int64))

    def _next_b(self, li: int) -> int:
        is_last = li == self.depth - 1
        return min(self.topk if is_last else self._beam, self.n_cols[li])

    def _select_args(self, li: int) -> dict:
        return dict(n_cols=self.n_cols[li], n_chunks=self.n_cols[li - 1],
                    next_b=self._next_b(li))

    def _chunks(self, li: int) -> Tuple[int, int]:
        """This partition's first global chunk and real chunk count at
        ``li`` (the last local chunk is the phantom)."""
        lay = self.part.layers[li - self.level]
        return self.chunk_start * self._span(li), lay.chunk_rows.shape[0] - 1

    def _owned(self, li, parent_ids, parent_scores):
        """One level's owned combined scores, as the in-process planner
        computes them."""
        return owned_level_combined(
            self.part.layers[li - self.level], self.branching[li], self.part.d,
            self._xi, self._xv, self._xd, parent_ids, parent_scores, *self._chunks(li),
            method=self.method, score_mode=self.score_mode, qt=self._qt,
        )

    def _reply(self, li: int, ids: torch.Tensor, scores: torch.Tensor
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Enqueue the beam's copies to the host, then the level-``li+1``
        speculative product, then wait for the copies alone. Ids cross as
        ``<i4``, scores as ``<f4``, as the reference sends them."""
        ids_h = ids.to(torch.int32).to("cpu", non_blocking=True)
        sc_h = scores.to("cpu", non_blocking=True)
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(self.device))
        if li + 1 < self.depth:
            self._spec_comb, _ = self._owned(li + 1, ids, scores)
            self._spec_ids = ids
        else:
            self._spec_ids = self._spec_comb = None
        if copied is not None:
            copied.synchronize()
        return ids_h.numpy(), sc_h.numpy()

    def begin(
        self, xi: np.ndarray, xv: np.ndarray,
        parent_ids: np.ndarray, scores: np.ndarray,
        *, beam: Optional[int] = None, qt: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        # Per-batch tier override: the coordinator's begin header may narrow
        # beam/qt for this batch only; the next begin without one restores
        # the loaded settings.
        self._beam = self.beam if beam is None else int(beam)
        self._qt = self.qt if qt is None else int(qt)
        li = self.level
        dev = self.device
        self._xi, self._xv = _tensor(xi, dev), _tensor(xv, dev)
        self._xd = (scatter_dense(self._xi, self._xv, self.part.d)
                    if self.method in _NEEDS_DENSE else None)
        ids = _tensor(parent_ids, dev, torch.int64)
        sc = _tensor(scores, dev, torch.float32)
        comb, own = self._owned(li, ids, sc)
        return self._reply(li, *_local_select(ids, comb, own, **self._select_args(li)))

    def step(self, li: int, winner_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self._spec_ids is None:
            raise RuntimeError(f"step(level={li}) before begin/speculation")
        winners = _tensor(winner_ids, self.device, torch.int64)
        b_ids, b_sc = _reconcile_select(
            winners, self._spec_ids, self._spec_comb, *self._chunks(li),
            **self._select_args(li))
        return self._reply(li, b_ids, b_sc)


def _serve_connection(conn: socket.socket, state: dict) -> bool:
    """Serve one client connection. Returns True on a ``shutdown`` op.

    ``state`` holds the loaded ``"runner"`` (kept across connections) and
    the ``"device"`` a ``load`` builds on."""
    while True:
        try:
            header, arrays = recv_frame(conn)
        except (EOFError, OSError):
            return False  # client gone; back to accept()
        except (ValueError, KeyError, TypeError, struct.error):
            # Corrupt frame (oversized length prefix, malformed header): the
            # stream position is unknown, so drop this connection and keep
            # serving. The worker must survive garbage on the wire.
            traceback.print_exc(file=sys.stderr)
            return False
        op = header.get("op", "")
        try:
            if op == "ping":
                send_frame(conn, {"ok": True, "pid": os.getpid(),
                                  "loaded": state.get("runner") is not None})
            elif op == "load":
                state["runner"] = PartitionRunner(header, arrays, device=state.get("device"))
                send_frame(conn, {"ok": True})
            elif op == "begin":
                ids, sc = state["runner"].begin(
                    *arrays, beam=header.get("beam"), qt=header.get("qt"))
                send_frame(conn, {"ok": True}, [ids, sc])
            elif op == "step":
                ids, sc = state["runner"].step(int(header["level"]), arrays[0])
                send_frame(conn, {"ok": True}, [ids, sc])
            elif op == "shutdown":
                send_frame(conn, {"ok": True})
                return True
            else:
                send_frame(conn, {"ok": False, "error": f"unknown op {op!r}"})
        except Exception as exc:  # noqa: BLE001 — report, keep serving
            traceback.print_exc(file=sys.stderr)
            try:
                send_frame(conn, {"ok": False, "error": f"{type(exc).__name__}: {exc}"})
            except OSError:
                return False


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (bound port printed on stdout)")
    ap.add_argument("--device", default=None,
                    help="device of the partition (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # fail before announcing, not at load

    if hasattr(signal, "SIGTERM"):
        # Graceful stop (WorkerHandle.kill's grace window). Flush and exit at
        # once: raising SystemExit from a handler mid-exchange would unwind
        # through library frames and spew tracebacks at teardown.
        def _on_sigterm(*_):
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)

        signal.signal(signal.SIGTERM, _on_sigterm)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(1)
    print(json.dumps({"port": srv.getsockname()[1], "pid": os.getpid()}), flush=True)

    state: dict = {"runner": None, "device": device}
    try:
        while True:
            conn, _ = srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                if _serve_connection(conn, state):
                    return 0
            finally:
                conn.close()
    finally:
        srv.close()


if __name__ == "__main__":
    sys.exit(main())
