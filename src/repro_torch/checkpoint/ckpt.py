"""Checkpointing: logical arrays + manifest, async, atomic.

Counterpart of ``repro.checkpoint.ckpt``, in the same format: a directory
per step holding one ``.npy`` per pytree leaf (named by its flattened path)
and ``manifest.json`` (step, sorted leaf names, metadata). The files are byte
for byte the reference's, so each package restores the other's checkpoints.

A leaf's path is the reference's: dict keys in sorted order, list and tuple
indices, and ``.field`` for a dataclass (the port's ``TreeLayerArrays`` and
``QuantLayerArrays``, which the reference registers as pytrees; a namedtuple
the same); path parts join with ``/`` and the file name replaces ``/`` with
``__`` (``layers/0/.chunk_rows`` -> ``layers/0__.chunk_rows.npy``). ``None``
is an empty subtree. Leaves are tensors, numpy arrays or scalars.

numpy has no bf16 or fp8 type. The reference writes such leaves as the raw
bytes of a void array (``<V2``, ``<V1``); the port writes the same bytes and,
on restore, views a void array back through the template leaf's dtype. (The
reference cannot restore those files itself.)

Writes are atomic (tmp dir + rename) and optionally asynchronous: ``save``
copies every leaf to host memory first, so the caller may change its tensors
at once, and the file I/O runs on a thread. An error on that thread is
raised by the next ``wait``, ``save`` or ``restore``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import resolve_device

Params = Any

# dtypes numpy lacks: the integer type of the same width their bytes cross as
_RAW = {
    torch.bfloat16: (np.int16, torch.int16),
    torch.float8_e4m3fn: (np.uint8, torch.uint8),
}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_dataclass_node(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of an inner node in the reference's order;
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if _is_dataclass_node(node):
        return [("." + f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _leaves_with_path(tree, prefix: Tuple[str, ...] = ()):
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for part, child in kids:
        yield from _leaves_with_path(child, prefix + (part,))


def _rebuild(template, values):
    """``template``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if template is None:
        return None
    if isinstance(template, dict):
        done = {k: _rebuild(template[k], values) for k in sorted(template)}
        return {k: done[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), values)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(c, values) for c in template)
    if _is_dataclass_node(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), values)
            for f in dataclasses.fields(template)})
    return next(values)


def _host_copy(leaf) -> np.ndarray:
    """A host snapshot of one leaf as numpy; bf16 and fp8 as void arrays of
    their bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _RAW:
            raw = t.view(_RAW[t.dtype][1]).numpy()
            return raw.view(np.dtype(f"V{raw.itemsize}"))
        return t.numpy()
    return np.array(leaf)


def _flatten(tree: Params) -> Dict[str, np.ndarray]:
    return {key: _host_copy(leaf) for key, leaf in _leaves_with_path(tree)}


def _save_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, but a void array's header names it ``<V{n}``, as numpy
    writes the reference's bf16 / fp8 arrays."""
    if arr.dtype.kind != "V":
        np.save(path, arr)
        return
    header = {"descr": f"<V{arr.itemsize}", "fortran_order": False, "shape": arr.shape}
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_file(arr: np.ndarray, leaf, device: torch.device) -> torch.Tensor:
    """The tensor of one restored file, cast to the template leaf's dtype as
    the reference casts; a void array is viewed through that dtype."""
    dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else None
    if arr.dtype.kind == "V":
        if dtype not in _RAW or arr.itemsize != dtype.itemsize:
            raise TypeError(f"a {arr.dtype} file restores only into a leaf of a "
                            f"{arr.itemsize}-byte float type; the template has {dtype}")
        t = torch.from_numpy(arr.view(_RAW[dtype][0])).view(dtype)
    else:
        if isinstance(leaf, np.ndarray):
            arr = arr.astype(leaf.dtype)
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t.to(dtype) if dtype is not None else t


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------
    def save(self, step: int, state: Dict[str, Params],
             metadata: Optional[dict] = None) -> None:
        """state: dict of named pytrees (e.g. {'params':…, 'opt':…})."""
        snap = {name: _flatten(tree) for name, tree in state.items()}
        meta = {
            "step": int(step),
            "names": {n: sorted(v.keys()) for n, v in snap.items()},
            "metadata": metadata or {},
        }
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_recording, args=(step, snap, meta), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, snap, meta)

    def _write_recording(self, step: int, snap, meta) -> None:
        try:
            self._write(step, snap, meta)
        except Exception as e:  # raised again by the next wait()
            self._error = e

    def _write(self, step: int, snap, meta) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, leaves in snap.items():
            sub = os.path.join(tmp, name)
            os.makedirs(sub)
            for key, arr in leaves.items():
                fn = key.replace("/", "__") + ".npy"
                _save_npy(os.path.join(sub, fn), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        """Wait for an asynchronous write; raise its error, if it failed."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read ----------------------------------------------------------
    def list_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: Dict[str, Params], step: Optional[int] = None,
                device: str | torch.device | None = None
                ) -> Tuple[int, Dict[str, Params]]:
        """Restore into the *structure* of ``template`` (values replaced).

        Each leaf is cast to the template leaf's dtype and placed on
        ``device`` if given, else on the template leaf's device (a leaf that
        is not a tensor: on the card). The reference's ``sharding=`` argument
        places leaves on a device mesh; on one card it has no counterpart.
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = os.path.join(self.dir, f"step_{step:08d}")
        dev = None if device is None else resolve_device(device)
        out: Dict[str, Params] = {}
        for name, tree in template.items():
            leaves = []
            for key, leaf in _leaves_with_path(tree):
                arr = np.load(os.path.join(base, name, key.replace("/", "__") + ".npy"))
                where = dev or (leaf.device if isinstance(leaf, torch.Tensor)
                                else resolve_device(None))
                leaves.append(_from_file(arr, leaf, where))
            out[name] = _rebuild(tree, iter(leaves))
        return step, out
