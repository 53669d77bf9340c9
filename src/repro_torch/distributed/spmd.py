"""The LM as one program over a device mesh: meshes and placements for
PyTorch's DTensor (the counterpart of GSPMD under the reference's
``jax.jit(..., in_shardings=...)``).

The rules of :mod:`repro_torch.distributed.sharding` give each tensor a
``PartitionSpec``; :func:`placements` turns it into DTensor placements, and
DTensor's sharding propagation inserts the collectives between ops, as XLA's
partitioner does. A mesh comes from :func:`spmd_mesh` with one of three
process-group backends:

* ``"nccl"``: one process a card;
* ``"gloo"``: one CPU process a rank, started by ``file://`` in a directory
  the caller gives (no TCP port);
* ``"fake"``: one process standing in for rank 0 of a world of any size
  (PyTorch's ``FakeProcessGroup``). Its collectives return at once and leave
  their outputs unwritten: the dry runs run rank 0's program on ``meta``
  tensors through it, and the card runs rank 0's program of the production
  mesh at full width, where nothing crosses a card and no value is checked.

:func:`spmd_mesh` owns the process's default group: it starts one, yields the
mesh and destroys the group on exit, so a process can build one world after
another.

:func:`activation_placements` is the reference's ``_shard_act``: the layer
loops call it on their activations. :func:`local_tree` draws each rank's own
shard from a seed, without the full tensor (yi-6b is 24.24 GB in f32).
"""

from __future__ import annotations

import contextlib
import math
import os
import zlib
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_leaves

from repro_torch.distributed.sharding import (NamedSharding, _map_with_path, _path_str,
                                             data_axes)

#: The production meshes' shapes and axis names, read by
#: :func:`spmd_mesh` and ``launch.mesh.make_production_mesh``.
PRODUCTION = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}

_DEVICE_TYPE = {"nccl": "cuda", "gloo": "cpu", "fake": "cuda"}


def _fake_store():
    """The store of a ``"fake"`` group. ``fake_pg`` is a module of PyTorch's
    test utilities; importing it also registers the ``"fake"`` backend. This
    is the one place the port imports it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


@contextlib.contextmanager
def spmd_mesh(mesh: str | Sequence[int], axis_names: Optional[Sequence[str]] = None, *,
              backend: str, rank: int = 0,
              init_dir: Optional[str] = None) -> Iterator[DeviceMesh]:
    """A :class:`DeviceMesh` of ``mesh`` (``"single"`` / ``"multi"`` for a
    production mesh, or a shape with its ``axis_names``) over a new default
    process group, destroyed on exit.

    ``backend="gloo"`` and ``"nccl"`` start the group by ``file://`` in
    ``init_dir``, as ``rank`` of the mesh's size; ``"fake"`` is rank
    ``rank`` alone. The mesh's device type is ``"cuda"`` for nccl and fake
    (a fake mesh holds ``meta`` local tensors on a machine without a card),
    ``"cpu"`` for gloo."""
    if isinstance(mesh, str):
        shape, axis_names = PRODUCTION[mesh]
    else:
        shape = tuple(int(n) for n in mesh)
    if axis_names is None or len(axis_names) != len(shape):
        raise ValueError(f"mesh {shape} needs one axis name a dim, got {axis_names}")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; spmd_mesh starts its own")
    world = math.prod(shape)
    if backend == "fake":
        dist.init_process_group("fake", store=_fake_store(), rank=rank, world_size=world)
    elif backend in ("gloo", "nccl"):
        if init_dir is None:
            raise ValueError(f"backend {backend!r} needs init_dir (started by file://)")
        dist.init_process_group(backend, init_method="file://" + os.path.join(
            os.path.abspath(init_dir), "rendezvous"), rank=rank, world_size=world)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    try:
        dev = _DEVICE_TYPE[backend]
        if dev == "cuda" and torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        ranks = torch.arange(world, dtype=torch.int).reshape(shape)
        yield DeviceMesh(dev, ranks, mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


class RuleMesh:
    """The names and sizes of a :class:`DeviceMesh`'s axes, in the form the
    sharding rules read (``axis_names`` and a ``shape`` dict, as a
    ``jax.sharding.Mesh``)."""

    def __init__(self, mesh: DeviceMesh) -> None:
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))


def placements(spec: Sequence[Any], mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of a ``PartitionSpec`` on ``mesh``: each mesh axis
    that names a dim of the spec shards that dim, every other mesh axis
    replicates. A dim over several axes (``("pod", "data")``) is sharded by
    each, in the spec's order, which must be the mesh's."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * mesh.ndim
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: Sequence[int], mesh: DeviceMesh,
                places: Sequence[Placement]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's block of a tensor of ``shape``: (its shape, its offset)."""
    return compute_local_shape_and_global_offset(tuple(shape), mesh, places)


def _places(mesh: DeviceMesh, sharding: NamedSharding) -> Tuple[Placement, ...]:
    return placements(sharding.spec, mesh)


class _Pair:
    """A leaf and its sharding, as one leaf of a tree."""

    __slots__ = ("leaf", "sharding")

    def __init__(self, leaf, sharding) -> None:
        self.leaf, self.sharding = leaf, sharding


def _zip_tree(tree, shardings):
    """``_Pair``s of (leaf, its sharding) in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: _zip_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_tree(v, s) for v, s in zip(tree, shardings))
    return _Pair(tree, shardings)


def distribute_tree(tree, shardings, mesh: DeviceMesh):
    """DTensors of ``tree``'s full tensors (the same on every rank), each
    placed by its :class:`NamedSharding`: every rank keeps its own block,
    nothing is sent."""
    return _map_with_path(
        lambda _, pair: distribute_tensor(pair.leaf, mesh, _places(mesh, pair.sharding),
                                          src_data_rank=None),
        _zip_tree(tree, shardings))


def _leaf_seed(seed: int, path: str, coord: Sequence[int]) -> int:
    return zlib.crc32(f"{seed}|{path}|{tuple(coord)}".encode())


def local_tree(shapes, shardings, mesh: DeviceMesh, *, seed: int,
               device: str | torch.device, high: int = 2):
    """DTensors of ``shapes``' tree (``meta`` tensors), each rank's block
    drawn on ``device`` from a seed of (``seed``, leaf path, the rank's mesh
    coordinate), so a rank's block is the same in every run: float leaves
    ``N(0, 1) / sqrt(shape[-2])`` (1-D ones: ones), integer leaves uniform
    in ``[0, high)``. The full
    tensor is never built; blocks of one tensor on two ranks differ as
    blocks of a random tensor do."""
    coord = mesh.get_coordinate()

    def draw(path, pair):
        meta, sharding = pair.leaf, pair.sharding
        places = _places(mesh, sharding)
        shape, _ = local_shape(meta.shape, mesh, places)
        g = torch.Generator(device).manual_seed(_leaf_seed(seed, _path_str(path), coord))
        if not meta.dtype.is_floating_point:
            local = torch.randint(0, high, shape, generator=g, device=device, dtype=meta.dtype)
        elif meta.dim() <= 1:
            local = torch.ones(shape, dtype=meta.dtype, device=device)
        else:
            local = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
            local = (local / float(meta.shape[-2]) ** 0.5).to(meta.dtype)
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=meta.shape, stride=meta.stride())

    return _map_with_path(draw, _zip_tree(shapes, shardings))


def zeros_tree(shapes, shardings, mesh: DeviceMesh, *, device: str | torch.device):
    """DTensors of zeros in ``shapes``' tree, each rank's block allocated on
    ``device`` (``meta`` for shapes alone)."""
    def zeros(_, pair):
        meta, sharding = pair.leaf, pair.sharding
        places = _places(mesh, sharding)
        shape, _ = local_shape(meta.shape, mesh, places)
        local = torch.zeros(shape, dtype=meta.dtype, device=device)
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=meta.shape, stride=meta.stride())

    return _map_with_path(zeros, _zip_tree(shapes, shardings))


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A plain tensor of ``x``: its full value on every rank for a DTensor
    (``x`` itself for a plain tensor)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def full_tree(tree):
    """The full tensors of a tree of DTensors (gathered on every rank)."""
    return _map_with_path(lambda _, t: replicated(t), tree)


def data_mesh_dims(mesh: DeviceMesh) -> Tuple[int, ...]:
    """The mesh dims of the data-parallel axes (``sharding.data_axes``)."""
    data = data_axes(RuleMesh(mesh))
    return tuple(i for i, a in enumerate(mesh.mesh_dim_names) if a in data)


def model_mesh_dims(mesh: DeviceMesh) -> Tuple[int, ...]:
    """The mesh dims of every other axis (``"model"``)."""
    data = data_mesh_dims(mesh)
    return tuple(i for i in range(mesh.ndim) if i not in data)


def mesh_size(mesh: DeviceMesh, dims: Sequence[int]) -> int:
    """The number of ranks along the mesh dims ``dims``."""
    return math.prod(mesh.size(i) for i in dims)


def divides(n: int, size: int) -> bool:
    """Whether ``n`` (heads, a batch, a sequence) splits into ``size``
    whole, non-empty blocks: the rules' test for a dim over mesh axes of
    ``size`` ranks."""
    return n % size == 0 and n >= size


def program(tree) -> contextlib.AbstractContextManager:
    """The context an entry point runs in: ``implicit_replication()`` when
    ``tree`` holds DTensors (the plain tensors made inside, such as scalars,
    act as replicated), else nothing. Tensors that autograd saves for the
    backward are made replicated DTensors instead (:func:`replicate_like`):
    the backward does not run under this context."""
    if any(isinstance(t, DTensor) for t in tree_leaves(tree)):
        return implicit_replication()
    return contextlib.nullcontext()


def batch_placements(shape: Sequence[int], mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """A tensor's dim 0 over the data-parallel axes when it divides them,
    every other mesh axis replicated (all replicated when it does not)."""
    dims = data_mesh_dims(mesh)
    size = mesh_size(mesh, dims)
    split = bool(dims) and len(shape) > 0 and divides(shape[0], size)
    return tuple(Shard(0) if split and i in dims else Replicate() for i in range(mesh.ndim))


def activation_placements(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``_shard_act``: ``x`` (a DTensor) redistributed to its
    batch dim over the data-parallel axes and replicated over every other
    axis, when that dim divides; otherwise ``x`` as it is (the reference
    adds no constraint then). A plain tensor is returned unchanged."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = batch_placements(x.shape, mesh)
    if not any(isinstance(p, Shard) for p in want):
        return x
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def replicate_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor every rank holds whole: a RoPE table, a mask, a
    scale) as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor,
    else ``t``. Autograd saves such tensors for the backward, which does not
    run under the entry points' ``implicit_replication()``."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every partial sum reduced: a mesh dim on which ``x`` is
    ``Partial`` becomes the batch's placement there (an all-reduce, or a
    reduce-scatter onto the batch's shard). Other placements stay."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    rows = batch_placements(x.shape, x.device_mesh)
    return x.redistribute(x.device_mesh, tuple(rows[i] if isinstance(p, Partial) else p
                                               for i, p in enumerate(x.placements)))


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward reduces a partial-sum gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduced(grad)


def reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient is reduced when it comes back a partial
    sum (Megatron's ``f``). An activation that feeds column-parallel
    products gets back the sum of partial gradients over ``model``: reducing
    it here, once, keeps DTensor from carrying a partial gradient into the
    row-parallel products upstream, where it would replicate their
    backward's compute over ``model``."""
    return _ReduceGrad.apply(x) if isinstance(x, DTensor) else x


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; the backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def to_local(x: DTensor) -> torch.Tensor:
    """``x``'s block on this rank, whose gradient comes back contiguous. A
    local product's gradient can come back in another memory order (an
    einsum's backward hands its operands' gradients back as permuted views);
    wrapped as a DTensor, such a block breaks the views that split or merge
    its dims upstream (the heads' reshapes of a projection)."""
    return _ContiguousGrad.apply(x.to_local())


def matmul_operands(a: torch.Tensor, w: DTensor) -> Tuple[DTensor, DTensor]:
    """The operands of ``a @ w`` for a 2-D weight DTensor ``w`` placed by
    the rules: ``w`` gathered over the data-parallel axes (its FSDP shard;
    the backward reduce-scatters its gradient), ``a`` with its batch over
    the data axes and, over the other axes, its last dim sharded where
    ``w``'s input dim is (a row-parallel product, whose output is a partial
    sum) and replicated elsewhere (a column-parallel one)."""
    mesh = w.device_mesh
    data = data_mesh_dims(mesh)
    wp = tuple(Replicate() if i in data else p for i, p in enumerate(w.placements))
    a = replicate_like(a, w)
    rows = batch_placements(a.shape, mesh)
    ap = tuple(Shard(a.ndim - 1) if isinstance(wp[i], Shard) and wp[i].dim == 0 else rows[i]
               for i in range(mesh.ndim))
    if tuple(a.placements) != ap:
        a = a.redistribute(mesh, ap)
    if tuple(w.placements) != wp:
        w = w.redistribute(mesh, wp)
    return a, w


def split_dim(x: DTensor, dim: int, outer: int) -> DTensor:
    """``x`` ready to have dim ``dim`` split into ``(outer, -1)``: gathered
    over the mesh dims that shard it when their size does not divide
    ``outer`` (DTensor cannot unflatten such a shard)."""
    dim %= x.ndim
    over = sharding_dims(x, dim)
    if not over or outer % mesh_size(x.device_mesh, over) == 0:
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if i in over else p
                                               for i, p in enumerate(x.placements)))


def sharding_dims(x: DTensor | Sequence[Placement], dim: int) -> Tuple[int, ...]:
    """The mesh dims that shard tensor dim ``dim`` of ``x`` (a DTensor, or
    its placements; ``dim`` counted from the front)."""
    places = x.placements if isinstance(x, DTensor) else x
    return tuple(i for i, p in enumerate(places) if isinstance(p, Shard) and p.dim == dim)


def reduce_over(local: torch.Tensor, rows: Sequence[Placement], dims: Sequence[int],
                mesh: DeviceMesh, op: str = "sum") -> DTensor:
    """``local``, this rank's part of a reduction (``op``: ``"sum"`` or
    ``"max"``) over the mesh dims ``dims``, reduced over them (an
    all-reduce; differentiable): a DTensor placed as ``rows`` elsewhere. The
    explicit reduction after a local pick."""
    places = tuple(Partial(op) if i in dims else rows[i] for i in range(mesh.ndim))
    return DTensor.from_local(local, mesh, places, run_check=False).redistribute(
        mesh, tuple(rows))


def split_rows(rows: Sequence[Placement]) -> Tuple[int, ...]:
    """The mesh dims along which ``rows`` (a tensor's placements) shard the
    rows: where ranks hold different rows, so a weight they all apply has a
    gradient that is a partial sum over these dims."""
    return tuple(i for i, p in enumerate(rows) if isinstance(p, Shard))


def sequence_placements(shape: Sequence[int], mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """A ``[B, S, ...]`` activation's batch over the data-parallel axes
    (:func:`batch_placements`) and its sequence (dim 1) over the model axes,
    when ``S`` divides them (the reference's sequence-parallel attention);
    the batch placements alone when it does not."""
    rows = batch_placements(shape, mesh)
    model = model_mesh_dims(mesh)
    size = mesh_size(mesh, model)
    if len(shape) < 2 or not model or not divides(shape[1], size):
        return rows
    return tuple(Shard(1) if i in model else p for i, p in enumerate(rows))


def local_block(t: DTensor, places: Sequence[Placement], *,
                grad_partial: Sequence[int] = ()) -> torch.Tensor:
    """This rank's block of ``t`` redistributed to ``places``, as a plain
    tensor whose gradient comes back a partial sum over the mesh dims
    ``grad_partial`` (ranks along them apply the block to rows of their
    own) and placed as ``places`` elsewhere. A weight gathered for a product
    on local rows (``places`` replicated) takes the rows'
    :func:`split_rows` there."""
    mesh = t.device_mesh
    places = tuple(places)
    if tuple(t.placements) != places:
        t = t.redistribute(mesh, places)
    return t.to_local(grad_placements=tuple(Partial() if i in grad_partial else p
                                            for i, p in enumerate(places)))


def from_block(local: torch.Tensor, mesh: DeviceMesh, places: Sequence[Placement],
               shape: Sequence[int]) -> DTensor:
    """A DTensor of global ``shape`` placed as ``places`` whose block on
    this rank is ``local`` (differentiable; nothing is sent)."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, tuple(places), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def exclusive_scan(counts: torch.Tensor, dims: Sequence[int], mesh: DeviceMesh
                   ) -> torch.Tensor:
    """The sum of ``counts`` (a plain tensor each rank holds) over the ranks
    that come before this one along the mesh dims ``dims``, in the order
    their blocks take in a tensor sharded over them (zeros for the first;
    ``counts`` itself is left out). One all-gather of ``counts``."""
    if not dims:
        return torch.zeros_like(counts)
    places = tuple(Shard(0) if i in dims else Replicate() for i in range(mesh.ndim))
    every = DTensor.from_local(counts[None], mesh, places, run_check=False).full_tensor()
    coord, idx = mesh.get_coordinate(), 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return every[:idx].sum(0)


def write_block(buf: DTensor, val: torch.Tensor, *, dim: int, start: int) -> None:
    """``buf[..., start:start + n, ...] = val`` along ``dim`` (``n`` =
    ``val.shape[dim]``) on a DTensor ``buf`` whose ``dim`` may be sharded:
    ``val`` is brought to ``buf``'s placements with ``dim`` whole, and each
    rank writes the part that falls in its own block, in place, in ``buf``'s
    dtype. Nothing of ``buf`` is gathered."""
    mesh = buf.device_mesh
    val = replicate_like(val, buf)
    if start == 0 and tuple(val.shape) == tuple(buf.shape):
        # the whole of ``buf``: each rank takes its own block of ``val``
        buf.to_local().copy_(val.redistribute(mesh, buf.placements).to_local())
        return
    whole = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                  for p in buf.placements)
    val = val.redistribute(mesh, whole).to_local()
    shape, off = local_shape(buf.shape, mesh, buf.placements)
    n = val.shape[dim]
    lo, hi = max(start, off[dim]), min(start + n, off[dim] + shape[dim])
    if lo < hi:
        buf.to_local().narrow(dim, lo - off[dim], hi - lo).copy_(
            val.narrow(dim, lo - start, hi - lo))
