"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (one or more entry
points, listed in :data:`SIGNATURES`). At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the
root of the checkout, under a name that carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags (so an edited source or header
is rebuilt), and loaded with ``ctypes``. Nothing
here runs at import time: the CPU tests import every module of the port on
machines without ``nvcc``.

Building and loading hold one lock, so two threads of a process (a
batcher's worker and a caller) that first reach a kernel together run one
``nvcc``; ``nvcc`` writes to a temporary file named by process and thread,
renamed into place once complete, so that processes sharing ``build/``
never write one file either.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: argtypes of each C entry point, by source name and function name.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "mscm_grouped": {
        # xg, vals, tile_chunk, tile_src, ps, out, T, QT, R, B, C, mode,
        # then the launch plan (pass_rows, warp_rows, slab_rows, bulk, stages,
        # grid, group_rows, window_cols), stream
        "mscm_grouped_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # xg, vals, scales, tile_chunk, tile_src, ps, out, T, QT, R, B, C, mode,
        # dtype, then the launch plan, stream
        "mscm_grouped_q_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "mscm_block": {
        # x_dense, rows, vals, block_q, block_c, out, A, Dp, R, B, C, n, dtype,
        # then the launch plan (S, rps, slab, stages, bulk, window_cols), stream
        "mscm_fused_launch": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P),
        # xg, vals, block_c, out, A, R, B, C, dtype, S, rps, slab, stages, bulk,
        # window_cols, stream
        "mscm_pregather_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build, by name.
BUILD_LOGS: Dict[str, str] = {}
#: Held while building or loading: guards ``_LIBS``, ``BUILD_LOGS`` and the
#: build directory against the other threads of this process.
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _tmp_path(lib: Path) -> Path:
    """Where ``nvcc`` writes ``lib`` before the rename: named by process and
    thread, so that no two builds ever write one file."""
    return lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")


def build_libraries(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, with one
    ``nvcc`` per source, all started together. Returns the library paths."""
    with _LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, Path]:
    targets = {n: _target(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    nvcc = None
    for name, (src, lib) in targets.items():
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = _tmp_path(lib)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, targets[name][1])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: lib for n, (_, lib) in targets.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)  # another thread may have loaded it meanwhile
        if lib is None:
            lib = ctypes.CDLL(str(_build([name])[name]))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib
