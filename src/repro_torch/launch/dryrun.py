"""Multi-pod dry run: every (arch x shape x mesh) cell's step, run on shapes
alone (counterpart of ``repro.launch.dryrun``).

The reference proves the distribution config coherent without hardware by
lowering and compiling each cell's step with its real shardings on 512
placeholder host devices, and reads the roofline inputs from the compiled
artifact. The port compiles nothing: it runs the cell's step, eagerly, on
``meta`` tensors (``param_shapes``, ``input_specs``; ``make_train_step``,
``prefill`` or ``decode_step``) under an :class:`~repro_torch.launch.
hlo_stats.OpCounter`, which counts each op's FLOPs and bytes as PyTorch
dispatches it: what eager PyTorch would run and move on one device holding
the whole step. The sharding rules place the arguments on the ``meta``
production mesh (:func:`~repro_torch.launch.mesh.make_production_mesh`)
for the per-device bytes.

The record's keys, against the reference's:

=============================  ==========================================
port                           reference
=============================  ==========================================
``counted_flops``              ``hlo_flops`` (XLA's ``flops`` x chips)
``counted_flops_per_device``   ``hlo_flops_per_device``: here the whole
                               step's count over the chips, an even split
``counted_bytes``              ``hlo_bytes`` (``bytes accessed`` x chips)
``counted_bytes_per_device``   ``hlo_bytes_per_device`` (even split)
``memory``                     XLA's memory analysis: the argument bytes
                               one device holds, from ``shard_params``,
                               ``shard_opt_state``, ``batch_specs`` and
                               ``cache_specs`` (each dim over its spec's
                               mesh axes, rounded up); no temp, output or
                               code sizes (nothing is compiled)
``collective_bytes``           the same key, null: the port runs no LM step
                               across cards, so no collective is issued
``model_vs_counted_flops``     ``model_vs_hlo_flops``
``meta_run_s``                 ``lower_s`` and ``compile_s``
``top_ops``                    no counterpart: the ops moving most bytes
``probe``                      ``probe_l1`` / ``probe_l2`` / ``raw_scan_once``:
                               not run, and the record says why
=============================  ==========================================

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json (one
file per cell; re-runs skip existing files unless --force).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, runnable
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import (
    batch_specs, cache_specs, shard_opt_state, shard_params)
from repro_torch.launch import hw
from repro_torch.launch.hlo_stats import OpCounter
from repro_torch.launch.mesh import argument_bytes, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.train import init_opt_state, make_train_step
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import ArchConfig
from repro_torch.optim.optimizers import get_optimizer

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

PROBE_NOTE = ("no counterpart: XLA counts a scanned layer loop's body once, so the "
              "reference compiles L = 1 and L = 2 probes and extrapolates; the port's "
              "Python loop runs every layer and the counter sees each")
COLLECTIVE_NOTE = ("null: the port runs an LM step on one card; it has no cross-card "
                   "LM program (the reference's jax.jit with shardings), so no "
                   "collective is issued to count")


def _model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd); N = active params (MoE)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _meta(spec) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device="meta")


def _step_and_specs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """(fn, ``meta`` args, shardings) for this cell. Decode's position is
    a host int in the port (``decode_step`` reads it as one), not an
    argument."""
    specs = input_specs(cfg, shape)
    params = lm_lib.param_shapes(cfg)
    if shape.kind == "train":
        optimizer = get_optimizer(cfg.optimizer)
        opt = init_opt_state(optimizer, params)
        batch = {k: _meta(v) for k, v in specs.items()}
        fn = make_train_step(cfg, optimizer)
        args = (params, opt, batch)
        shardings = (shard_params(params, mesh), shard_opt_state(opt, params, mesh),
                     batch_specs(cfg, batch, mesh))
    elif shape.kind == "prefill":
        batch = {k: _meta(v) for k, v in specs.items()}

        def fn(params, batch):
            return lm_lib.prefill(cfg, params, batch, max_len=shape.seq_len)

        args = (params, batch)
        shardings = (shard_params(params, mesh), batch_specs(cfg, batch, mesh))
    else:  # decode
        cache = {k: _meta(v) for k, v in specs["cache"].items()}
        tokens = _meta(specs["tokens"])

        def fn(params, cache, tokens):
            return lm_lib.decode_step(cfg, params, cache, tokens, shape.seq_len - 1)

        args = (params, cache, tokens)
        shardings = (shard_params(params, mesh), cache_specs(cfg, cache, mesh),
                     batch_specs(cfg, {"t": tokens}, mesh)["t"])
    return fn, args, shardings


def count_step(fn, args) -> OpCounter:
    """Run ``fn(*args)`` under an :class:`OpCounter`; return it."""
    with OpCounter() as counter:
        fn(*args)
    return counter


def _apply_overrides(cfg: ArchConfig, overrides: Dict[str, Any]) -> ArchConfig:
    if not overrides:
        return cfg
    coerced = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            coerced[k] = v in ("1", "true", "True", True)
        elif isinstance(cur, int):
            coerced[k] = int(v)
        elif isinstance(cur, float):
            coerced[k] = float(v)
        else:
            coerced[k] = v
    return dataclasses.replace(cfg, **coerced)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    cfg = _apply_overrides(get_config(arch), overrides or {})
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "family": cfg.family,
    }
    if not runnable(cfg.family, shape):
        rec["status"] = "skipped(full-attention)"
        rec["reason"] = (
            "long_500k needs a sub-quadratic path; this arch is pure full "
            "attention (DESIGN.md §Arch-applicability)"
        )
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.devices.size
    fn, args, shardings = _step_and_specs(cfg, shape, mesh)
    arg_bytes = argument_bytes(args, shardings)
    t0 = time.time()
    counter = count_step(fn, args)
    run_s = time.time() - t0
    print(f"[{arch} {shape_name} {mesh_kind}] argument bytes per device: {arg_bytes:,}")
    print(f"[{arch} {shape_name} {mesh_kind}] counted: "
          f"flops={counter.flops:.3e} bytes={counter.bytes:.3e}")

    flops, bytes_hbm = float(counter.flops), float(counter.bytes)
    model_flops = _model_flops(cfg, shape)
    roofline = hw.roofline_terms(flops=flops, bytes_hbm=bytes_hbm, bytes_collective=0.0,
                                 chips=chips)
    roofline["collective_s"] = None
    rec.update(
        status="ok",
        chips=chips,
        meta_run_s=round(run_s, 2),
        counted_flops=flops,
        counted_flops_per_device=flops / chips,
        counted_bytes=bytes_hbm,
        counted_bytes_per_device=bytes_hbm / chips,
        collective_bytes=None,
        collective_bytes_per_device=None,
        collectives=None,
        collective_note=COLLECTIVE_NOTE,
        probe=PROBE_NOTE,
        memory={"argument_size_in_bytes": arg_bytes,
                "argument_gb_per_device": arg_bytes / 1e9},
        model_flops=model_flops,
        model_vs_counted_flops=(model_flops / flops if flops else None),
        roofline=roofline,
        top_ops=counter.top(8),
    )
    return rec


def cell_path(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", nargs="*", default=[],
                    help="ArchConfig overrides k=v (hillclimb lowering)")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (hillclimb iterations)")
    args = ap.parse_args()

    overrides = dict(kv.split("=", 1) for kv in args.override)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(arch, shape, mesh_kind, args.tag)
                if os.path.exists(path) and not args.force:
                    print(f"skip existing {path}")
                    continue
                print(f"=== {arch} × {shape} × {mesh_kind} ===", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_kind, overrides)
                    if overrides:
                        rec["overrides"] = overrides
                except Exception as e:
                    rec = {
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "status": "FAILED", "error": str(e),
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    failures.append((arch, shape, mesh_kind, str(e)))
                    print(f"FAILED: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("status") == "ok":
                    r = rec["roofline"]
                    print(
                        f"ok in {rec['meta_run_s']:.0f}s  compute {r['compute_s']:.4f}s"
                        f"  memory {r['memory_s']:.4f}s  collective n/a"
                        f"  dominant={r['dominant']}", flush=True,
                    )
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
    else:
        print("\nall requested cells passed")


if __name__ == "__main__":
    main()
