"""Production mesh construction (counterpart of ``repro.launch.mesh``).

A function, not a module-level constant: importing this module touches no
device. Single pod: ``(data=16, model=16)``, 256 devices; multi-pod adds a
leading pod axis, ``(pod=2, data=16, model=16)``. The reference's mesh needs
that many JAX devices (512 placeholder host devices in its dry runs); the
port's production mesh is a :class:`DeviceMesh` whose every slot is the
``meta`` device, so the dry runs (:mod:`repro_torch.launch.dryrun`,
:mod:`repro_torch.launch.serve_dryrun`) run each slot's program on shapes
alone, with no card. :func:`make_production_spmd_mesh` is the same mesh as a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh` of
256 or 512 ranks over a fake process group, on which this process runs rank
0's DTensor program.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    DeviceMesh, NamedSharding, partition_mesh, resolve_devices)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape, axes = spmd.PRODUCTION["multi" if multi_pod else "single"]
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [torch.device("meta")] * devices.size
    return DeviceMesh(devices.reshape(shape), axes)


@contextlib.contextmanager
def make_production_spmd_mesh(*, multi_pod: bool = False) -> Iterator[Any]:
    """The production mesh as a fake-group ``DeviceMesh`` (device type
    ``"cuda"``; its blocks may be ``meta`` tensors), this process rank 0;
    the group is destroyed on exit."""
    with spmd.spmd_mesh("multi" if multi_pod else "single", backend="fake") as mesh:
        yield mesh


def make_host_mesh(n_data: int = 1, n_model: int = 1, *,
                   devices: Optional[Sequence] = None) -> DeviceMesh:
    """Small ``("data", "model")`` mesh over the visible device slots (every
    card unless ``devices`` names them; a device may repeat): tests and
    examples."""
    n = n_data * n_model
    avail = len(resolve_devices(devices))
    if n > avail:
        raise ValueError(f"need {n} devices, have {avail}")
    return partition_mesh(n_data, n_model, devices=devices)


def argument_bytes(args: Any, shardings: Any) -> int:
    """Bytes one device holds of ``args`` (a tree of tensors, ``meta`` ones
    included) placed by ``shardings`` (the same tree of
    :class:`NamedSharding`): each leaf's :meth:`NamedSharding.shard_shape`
    times its element size. The reference reads this from XLA's memory
    analysis (``argument_size_in_bytes``)."""
    tensors = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    specs = [s for s in tree_leaves(shardings) if isinstance(s, NamedSharding)]
    if len(tensors) != len(specs):
        raise ValueError(f"{len(tensors)} tensors against {len(specs)} shardings")
    return sum(int(np.prod(s.shard_shape(t.shape), dtype=np.int64)) * t.element_size()
               for t, s in zip(tensors, specs))
