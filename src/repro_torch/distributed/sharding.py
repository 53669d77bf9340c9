"""Device meshes for the serving tier, the stream hand-offs between them, and
the LM's sharding rules (counterpart of ``repro.distributed.sharding``).

A :class:`DeviceMesh` is a numpy object array of ``torch.device`` with named
axes, as a ``jax.sharding.Mesh`` is of JAX devices: ``("data",)`` for the
replicated engine (:func:`replica_mesh`), ``("data", "model")`` for the
label-partitioned one (:func:`partition_mesh`). The default device list is
every visible card. A list may name one device more than once: each entry is
a **device slot** with its own CUDA stream, so one card can stand in for a
mesh (on the CPU, for the tests; on one GPU, for concurrent partitions).

Where JAX places arrays by sharding and orders the transfers itself, the port
moves tensors between slots with :func:`send`: an event on the producing
stream, a wait on the consuming one, and ``record_stream`` so that the
caching allocator does not hand out the memory early.

The LM's sharding rules (``param_spec``, ``shard_params``,
``shard_opt_state``, ``batch_specs``, ``cache_specs``) are the reference's,
as pure shape logic over any mesh that has ``axis_names`` and a ``shape``
dict (a :class:`DeviceMesh`, or a stand-in of a mesh larger than the
machine). The mesh is ("data", "model") in one pod or ("pod", "data",
"model") across pods. Policy:

* batch/token dims           -> all data-parallel axes ("pod", "data")
* output-feature dims (heads, ffn-out-of-d, vocab, experts) -> "model" (TP)
* the complementary feature dim -> "data" (FSDP within a pod)
* stacked-layer leading dim  -> never sharded (the layer loop's axis)
* 1-D tensors (norm scales)  -> replicated
* every assignment checks divisibility and falls back down the preference
  list; dims that do not divide end up replicated rather than erroring.

They return the port's :class:`PartitionSpec` (a tuple, as JAX's) in a
:class:`NamedSharding` record of ``(mesh, spec)``; on one card nothing is
placed by them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def canonical_device(device: str | torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card, so that
    two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> List[torch.device]:
    """Every visible card, in index order (empty without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A numpy object array of ``torch.device`` with named axes."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))


def _device_array(devices: Sequence[torch.device], shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def resolve_devices(devices: Optional[Sequence]) -> List[torch.device]:
    """``devices`` (every visible card when None), each with its index."""
    return [canonical_device(d) for d in (devices if devices is not None else visible_devices())]


def replica_mesh(n: int, *, devices: Sequence | None = None) -> DeviceMesh:
    """1-D ``("data",)`` mesh over the first ``n`` device slots: the tree is
    replicated on each, and a dispatched bucket's rows split over them."""
    devices = resolve_devices(devices)
    if len(devices) < n:
        raise ValueError(
            f"replica_mesh(n={n}): only {len(devices)} device slots "
            "(pass devices=; a device may be named more than once)"
        )
    return DeviceMesh(_device_array(devices[:n], (n,)), ("data",))


def partition_mesh(
    n_data: int, n_model: int, *, devices: Sequence | None = None
) -> DeviceMesh:
    """2-D ``("data", "model")`` mesh over the first ``n_data * n_model``
    device slots: each model column hosts one or more label partitions
    (:mod:`repro_torch.index.placement`), replicated down its ``n_data``
    rows; batch rows split over ``"data"`` as in :func:`replica_mesh`."""
    need = n_data * n_model
    devices = resolve_devices(devices)
    if len(devices) < need:
        raise ValueError(
            f"partition_mesh({n_data}x{n_model}): needs {need} device slots, "
            f"only {len(devices)} (pass devices=; a device may be named more "
            "than once)"
        )
    return DeviceMesh(_device_array(devices[:need], (n_data, n_model)),
                      ("data", "model"))


# ---------------------------------------------------------------------------
# device slots and the hand-offs between their streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Slot:
    """A place work runs: a device and, on a GPU, the stream it is enqueued
    on. ``stream=None`` is the caller's current stream (on the CPU there is
    none)."""

    device: torch.device
    stream: Optional["torch.cuda.Stream"] = None

    @classmethod
    def new(cls, device: str | torch.device) -> "Slot":
        """A slot on ``device`` with a stream of its own on a GPU."""
        dev = canonical_device(device)
        return cls(dev, torch.cuda.Stream(device=dev) if dev.type == "cuda" else None)

    @classmethod
    def current(cls, device: str | torch.device) -> "Slot":
        """The caller's slot on ``device``: its current stream, as of now
        (so that work enqueued later under another slot's stream context
        still hands back to it)."""
        dev = canonical_device(device)
        return cls(dev, torch.cuda.current_stream(dev) if dev.type == "cuda" else None)

    def current_stream(self) -> Optional["torch.cuda.Stream"]:
        if self.device.type != "cuda":
            return None
        return self.stream if self.stream is not None else torch.cuda.current_stream(self.device)

    def enter(self):
        """Context in which work is enqueued on this slot's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


#: The open :func:`record_sends` logs; :func:`send` appends to each.
_SEND_LOGS: List[list] = []


@contextlib.contextmanager
def record_sends():
    """Within the block, every :func:`send` between two distinct slots
    appends ``(src, dst, bytes)`` to the yielded list: the traffic that
    crosses device slots, counted on ``meta`` devices too, where nothing is
    copied. A slot sending to itself moves nothing and is not logged."""
    log: list = []
    _SEND_LOGS.append(log)
    try:
        yield log
    finally:
        _SEND_LOGS.remove(log)


def send(tensors: Sequence[torch.Tensor], src: Slot, dst: Slot) -> Tuple[torch.Tensor, ...]:
    """``tensors``, enqueued on ``src``, made readable by work enqueued on
    ``dst``. On one device the tensors are shared: ``dst``'s stream waits for
    an event recorded on ``src``'s, and each tensor is recorded on ``dst``'s
    stream so its memory is not reused before ``dst`` is done with it.
    Between devices they are copied, on ``src``'s stream, which PyTorch
    orders against ``dst``'s."""
    tensors = tuple(tensors)
    if src is dst:
        return tensors
    if _SEND_LOGS:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        for log in _SEND_LOGS:
            log.append((src, dst, nbytes))
    if src.device == dst.device:
        s_src, s_dst = src.current_stream(), dst.current_stream()
        if s_src is None or s_src == s_dst:
            return tensors
        s_dst.wait_event(s_src.record_event())
        for t in tensors:
            t.record_stream(s_dst)
        return tensors
    gpu = src.device.type == "cuda" and dst.device.type == "cuda"
    with src.enter(), dst.enter():
        return tuple(t.to(dst.device, non_blocking=gpu) for t in tensors)


def row_slices(n: int, parts: int) -> List[Tuple[int, int]]:
    """``[r0, r1)`` of each of ``parts`` near-equal runs of ``n`` rows (the
    split ``torch.tensor_split`` makes)."""
    q, r = divmod(n, parts)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(parts)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


# ---------------------------------------------------------------------------
# the LM's sharding rules
# ---------------------------------------------------------------------------

Params = Any


class PartitionSpec(tuple):
    """Per dim of a tensor: a mesh axis name, a tuple of names, or None
    (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of a tensor of ``global_shape``: each dim
        divided by the product of its spec's mesh axes, rounded up (XLA
        pads the last block)."""
        spec = tuple(self.spec) + (None,) * (len(global_shape) - len(self.spec))
        return tuple(-(-int(n) // axis_size(self.mesh, ax))
                     for n, ax in zip(global_shape, spec))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _assign(shape: Sequence[int], prefs: List[Tuple[int, Any]], mesh) -> PartitionSpec:
    """prefs: [(dim, axis-or-tuple)] in priority order; skip non-divisible."""
    spec: List[Any] = [None] * len(shape)
    used = set()
    for dim, ax in prefs:
        d = dim if dim >= 0 else len(shape) + dim
        if d < 0 or d >= len(shape) or spec[d] is not None:
            continue
        key = tuple(ax) if isinstance(ax, tuple) else (ax,)
        if any(k in used for k in key):
            continue
        if shape[d] % axis_size(mesh, ax) == 0 and shape[d] >= axis_size(mesh, ax):
            spec[d] = ax
            used.update(key)
    return P(*spec)


# name-pattern rules: (regex, fn(shape, n_leading) -> PartitionSpec)
def _param_rules(mesh):
    fsdp = "data" if "data" in mesh.axis_names else None

    def embed(shape, lead):
        return _assign(shape, [(0 + lead, "model"), (1 + lead, fsdp)], mesh)

    def head_out(shape, lead):  # [d, H*dh] / [d, ff]-style: out dim -> model
        return _assign(shape, [(-1, "model"), (-2, fsdp)], mesh)

    def head_in(shape, lead):   # [H*dh, d] / [ff, d]-style: in dim -> model
        return _assign(shape, [(-2, "model"), (-1, fsdp)], mesh)

    return [
        (re.compile(r"embed$"), embed),
        (re.compile(r"lm_head$"), head_out),
        (re.compile(r"(wq|wk|wv|w1|w3|wuq|wukv|wdq|wdkv|wx|wB|wC|wdt|router|ddw1|ww1|wkr)$"),
         head_out),
        (re.compile(r"(wo|w2|wr|wg|ww2|ddw2)$"), head_in),
        (re.compile(r"ffn/(w1|w3)$"), head_out),
    ]


def _path_str(path: Sequence[Any]) -> str:
    """A leaf's path (dict keys and sequence indices) joined with ``/``."""
    return "/".join(str(k) for k in path)


def param_spec(path: str, shape: Sequence[int], mesh, *,
               stacked: bool = True) -> PartitionSpec:
    """PartitionSpec for one parameter tensor."""
    if len(shape) <= 1:
        return P()
    lead = 1 if (stacked and "layers" in path and len(shape) >= 2) else 0
    # MoE expert tensors: [L, E, d, ff]. Prefer experts over 'model'
    # (qwen3: 128/16); when E does not divide the TP axis (grok: 8 < 16)
    # shard BOTH feature dims instead so the weight still spreads over
    # every device (d -> data, ff -> model for w1/w3; mirrored for w2).
    if re.search(r"ffn/(w1|w2|w3)$", path) and len(shape) - lead == 3:
        fsdp = "data" if "data" in mesh.axis_names else None
        e_dim = shape[lead]
        if e_dim % axis_size(mesh, "model") == 0 and e_dim >= axis_size(mesh, "model"):
            return _assign(
                shape,
                [(0 + lead, "model"), (1 + lead, fsdp), (2 + lead, None)],
                mesh,
            )
        return _assign(
            shape,
            [(2 + lead, "model"), (1 + lead, fsdp)],
            mesh,
        )
    for rx, fn in _param_rules(mesh):
        if rx.search(path):
            return fn(shape, lead)
    # generic fallback: shard the largest trailing dim on model, next on data
    fsdp = "data" if "data" in mesh.axis_names else None
    dims = sorted(range(lead, len(shape)), key=lambda i: -shape[i])
    prefs = []
    if dims:
        prefs.append((dims[0], "model"))
    if len(dims) > 1:
        prefs.append((dims[1], fsdp))
    return _assign(shape, prefs, mesh)


def _map_with_path(fn, tree, path: Tuple[Any, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; any other
    node (a tensor, a ``meta`` tensor, anything with ``shape``) is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params_shapes: Params, mesh) -> Params:
    """NamedSharding tree matching a params (or ``meta`` tensor) tree."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(_path_str(path), leaf.shape, mesh)),
        params_shapes)


def shard_opt_state(opt_shapes: Params, params_shapes: Params, mesh) -> Params:
    """Optimizer state mirrors its parameter's sharding (m/v same shape);
    factored adafactor rows/cols and scalars replicate on the missing dim.
    Each leaf takes the rule of its own path (``params_shapes`` is kept for
    the reference's signature)."""
    return shard_params(opt_shapes, mesh)


def batch_specs(cfg, batch_shapes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Input shardings: batch dim over all DP axes."""
    da = data_axes(mesh)
    dp = da if len(da) > 1 else (da[0] if da else None)

    def per_leaf(path, leaf):
        shape = leaf.shape
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        if shape[0] % axis_size(mesh, dp) == 0:
            return NamedSharding(mesh, P(dp, *([None] * (len(shape) - 1))))
        return NamedSharding(mesh, P())
    return _map_with_path(per_leaf, batch_shapes)


def cache_specs(cfg, cache_shapes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """KV-cache shardings for decode: [L, B, S, ...] -> B over DP axes,
    S over model (flash-decode style); SSM states shard heads over model."""
    da = data_axes(mesh)
    dp = da if len(da) > 1 else (da[0] if da else None)
    dp_size = axis_size(mesh, dp)
    model_size = axis_size(mesh, "model") if "model" in mesh.axis_names else 1

    def per_leaf(path, leaf):
        shape = leaf.shape
        name = _path_str(path)
        spec: List[Any] = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dp_size == 0 and shape[1] >= dp_size:
            spec[1] = dp  # batch
        if len(shape) >= 3 and "model" in (mesh.axis_names or ()):
            # seq dim for kv caches; head dim for ssm states
            if name in ("k", "v", "ckv", "kr", "cross_k", "cross_v"):
                if shape[2] % model_size == 0 and shape[2] >= model_size:
                    spec[2] = "model"
            elif name in ("tm_s", "ssd_s") and shape[2] % model_size == 0:
                spec[2] = "model"
        return NamedSharding(mesh, P(*spec))

    return _map_with_path(per_leaf, cache_shapes)
