"""Production mesh construction (counterpart of ``repro.launch.mesh``).

A function, not a module-level constant: importing this module touches no
device. Single pod: ``(data=16, model=16)``, 256 devices; multi-pod adds a
leading pod axis, ``(pod=2, data=16, model=16)``. The reference's mesh needs
that many JAX devices (512 placeholder host devices in its dry runs); the
port's production mesh is a :class:`DeviceMesh` whose every slot is the
``meta`` device, so the dry runs (:mod:`repro_torch.launch.dryrun`,
:mod:`repro_torch.launch.serve_dryrun`) run each slot's program on shapes
alone, with no card.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.distributed.sharding import (
    DeviceMesh, NamedSharding, partition_mesh, resolve_devices)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [torch.device("meta")] * devices.size
    return DeviceMesh(devices.reshape(shape), axes)


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
