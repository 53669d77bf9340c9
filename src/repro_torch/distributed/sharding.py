"""Device meshes for the serving tier, and the stream hand-offs between them
(counterpart of the mesh half of ``repro.distributed.sharding``).

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
caching allocator does not hand out the memory early. The rules of the
reference's LM parameter sharding (``param_spec``, ``shard_params``, ...)
are not ported here (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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


def send(tensors: Sequence[torch.Tensor], src: Slot, dst: Slot) -> Tuple[torch.Tensor, ...]:
    """``tensors``, enqueued on ``src``, made readable by work enqueued on
    ``dst``. On one device the tensors are shared: ``dst``'s stream waits for
    an event recorded on ``src``'s, and each tensor is recorded on ``dst``'s
    stream so its memory is not reused before ``dst`` is done with it.
    Between devices they are copied, on ``src``'s stream, which PyTorch
    orders against ``dst``'s."""
    tensors = tuple(tensors)
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
