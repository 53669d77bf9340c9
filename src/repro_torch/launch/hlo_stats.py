"""What a step moves and computes: the port's counterparts of XLA's
compiled-program analyses (``repro.launch.hlo_stats`` and the
``cost_analysis()`` its dry runs read).

The reference parses the text of the HLO that XLA compiled: a symbol table
of result shapes (``_shape_bytes`` of HLO type strings), then the operand
and result bytes of every all-gather, all-reduce, reduce-scatter,
all-to-all and collective-permute. The port compiles no HLO, so
``_shape_bytes`` has nothing to parse and is left out. It reads what it
does produce instead:

* :func:`collective_stats` takes the events of a ``torch.profiler`` trace
  (its Chrome trace JSON): the NCCL collectives, under the reference's op
  names, with the bytes the trace records for them (``In msg nelems`` and
  ``Out msg nelems`` times the element size), and the copies that cross
  device slots, ``Memcpy PtoP`` as ``peer-copy`` and ``Memcpy DtoD`` as
  ``device-copy``, with the trace's ``bytes``;
* :func:`send_stats` takes a :func:`repro_torch.distributed.sharding.
  record_sends` log: the tensors that :func:`~repro_torch.distributed.
  sharding.send` hands between distinct slots, as ``send``, counted on
  ``meta`` slots too, where nothing is copied;
* :class:`OpCounter` counts, op by op as eager PyTorch dispatches them, the
  FLOPs (``torch.utils.flop_counter``'s formulas) and the bytes read and
  written: the counterpart of XLA's ``flops`` and ``bytes accessed``.

Each returns the reference's record: ``{op: {count, operand_bytes,
result_bytes}, "TOTAL": {...}}`` for the traffic.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: Element bytes of the dtype names a trace records (c10's ScalarType names).
_DTYPE_BYTES = {
    "Bool": 1, "Byte": 1, "Char": 1, "Float8_e4m3fn": 1, "Float8_e5m2": 1,
    "Short": 2, "Half": 2, "BFloat16": 2, "Int": 4, "Float": 4, "Long": 8,
    "Double": 8, "ComplexFloat": 8, "ComplexDouble": 16,
}

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# (pattern in a c10d collective name, the reference's op name)
_COLLECTIVE_NAMES = (
    ("allgather", "all-gather"), ("allreduce", "all-reduce"),
    ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
)

_COPIES = (("Memcpy PtoP", "peer-copy"), ("Memcpy DtoD", "device-copy"))


def _collective_op(name: str) -> Optional[str]:
    """The reference's op name of a c10d collective (``_allgather_base``,
    ``allreduce``, ``reduce_scatter_tensor``, ``send`` ...), or None for one
    it does not count (a barrier, a receive: its peer's send counts it)."""
    key = name.lower().replace("_", "").replace("-", "")
    for pattern, op in _COLLECTIVE_NAMES:
        if pattern in key:
            return op
    return "collective-permute" if key == "send" else None


def _table(records: Iterable[Tuple[str, float, float]]) -> Dict[str, Dict[str, float]]:
    """``(op, operand bytes, result bytes)`` records -> the reference's
    per-op ``{count, operand_bytes, result_bytes}`` and ``TOTAL``."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0.0, "result_bytes": 0.0})
    for op, operand, result in records:
        rec = out[op]
        rec["count"] += 1
        rec["operand_bytes"] += operand
        rec["result_bytes"] += result
    out["TOTAL"] = {
        "count": sum(r["count"] for r in out.values()),
        "operand_bytes": sum(r["operand_bytes"] for r in out.values()),
        "result_bytes": sum(r["result_bytes"] for r in out.values()),
    }
    return dict(out)


def collective_stats(events) -> Dict[str, Dict[str, float]]:
    """Per-op ``{count, operand_bytes, result_bytes}`` plus ``TOTAL`` over a
    trace's events (a Chrome trace dict, or its ``traceEvents`` list).

    A collective is counted once, from its device kernel when the kernels
    carry the collective's metadata, else from the host's
    ``record_param_comms`` event (which older traces alone annotate)."""
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    events = [e for e in events if isinstance(e, dict)]
    comms = [e for e in events if "Collective name" in e.get("args", {})]
    chosen = [e for e in comms if e.get("cat") == "kernel"] or [
        e for e in comms if e.get("name") == "record_param_comms"]
    records = []
    for e in chosen:
        args = e["args"]
        op = _collective_op(str(args["Collective name"]))
        if op is None:
            continue
        es = _DTYPE_BYTES.get(str(args.get("dtype")), 0)
        records.append((op, float(args.get("In msg nelems", 0)) * es,
                        float(args.get("Out msg nelems", 0)) * es))
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        for prefix, op in _COPIES:
            if str(e.get("name", "")).startswith(prefix):
                nbytes = float(e.get("args", {}).get("bytes", 0))
                records.append((op, nbytes, nbytes))
    return _table(records)


def send_stats(log: Iterable[Tuple[Any, Any, int]]) -> Dict[str, Dict[str, float]]:
    """The same record over a :func:`~repro_torch.distributed.sharding.
    record_sends` log: one ``send`` an entry, its bytes both ways."""
    return _table(("send", float(b), float(b)) for _, _, b in log)


def trace_events(prof) -> List[dict]:
    """The Chrome trace events of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


# ---------------------------------------------------------------------------
# FLOPs and bytes, op by op
# ---------------------------------------------------------------------------

_aten = torch.ops.aten

#: Ops that move no data: allocations (nothing written yet) and aliases.
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten._unsafe_view.default, _aten.lift_fresh.default,
}

#: Gathers read only the elements they return, not their whole source.
_GATHERS = {
    _aten.index.Tensor, _aten.gather.default, _aten.index_select.default,
    _aten.embedding.default,
}

#: In-place scatters read and write only the elements they index.
_SCATTERS = {
    _aten.index_put_.default, _aten._index_put_impl_.default, _aten.scatter_add_.default,
    _aten.scatter_.src, _aten.scatter_.value, _aten.index_add_.default,
    _aten.scatter_reduce_.two,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one op reads and writes: each tensor input once and each
    output once, but a gather reads only what it returns and an in-place
    scatter touches only what it indexes (read and written)."""
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if func in _GATHERS:
        return sum(_nbytes(t) for t in ins[1:]) + 2 * sum(_nbytes(t) for t in outs)
    if func in _SCATTERS:
        dst, rest = ins[0], ins[1:]
        written = max((t.numel() for t in rest), default=0) * dst.element_size()
        return sum(_nbytes(t) for t in rest) + 2 * written
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched under it, on any device (``meta`` too):
    ``flops`` from ``torch.utils.flop_counter``'s formulas (matrix products,
    attention, convolutions; elementwise ops count none, as in XLA's
    ``flops`` they are a rounding error), ``bytes`` from :func:`op_bytes`,
    views and allocations skipped. ``by_op`` holds ``[count, flops, bytes]``
    for each op name. Autograd's backward and remat's recompute run through
    the same dispatcher and are counted as they run."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE:
            return out
        fn = self._flop_registry.get(func._overloadpacket)
        flops = int(fn(*args, **kwargs, out_val=out)) if fn is not None else 0
        nbytes = op_bytes(func, args, kwargs, out)
        rec = self.by_op[str(func._overloadpacket)]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.flops += flops
        self.bytes += nbytes
        return out

    def top(self, n: int = 8, key: int = 2) -> List[Tuple[str, int, int, int]]:
        """The ``n`` op names that move the most bytes (``key=1``: FLOPs),
        as ``(name, count, flops, bytes)``."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][key])[:n]
        return [(k, *v) for k, v in rows]
