"""Multi-pod dry run: every (arch x shape x mesh) cell's step, run on shapes
alone (counterpart of ``repro.launch.dryrun``).

The reference proves the distribution config coherent without hardware by
lowering and compiling each cell's step with its real shardings on 512
placeholder host devices, and reads the roofline inputs from the compiled
per-device program. The port compiles nothing: it runs the cell's step
(``make_train_step``, ``prefill`` or ``decode_step``) eagerly on ``meta``
tensors under an :class:`~repro_torch.launch.hlo_stats.OpCounter`, which
counts each op's FLOPs and bytes as PyTorch dispatches it.

For the families whose sharded program is ported (dense GQA decoders:
``spmd_family``), the step is rank 0's program of the production mesh: a
DTensor program (:mod:`repro_torch.distributed.spmd`) on a fake process
group of 256 or 512 ranks, its arguments placed by ``shard_params``,
``shard_opt_state``, ``batch_specs`` and ``cache_specs`` as ``meta``
blocks. The counter sees that rank's local ops and the collectives DTensor
issues: per-device counts with no even split. The mesh's device type is
``"cuda"``, so DTensor issues each collective as it would to NCCL (on a
``"cpu"`` mesh it would send an all-to-all as all-gather + chunk). Every
other family keeps one card's eager count of the whole step split evenly
over the chips, and its record says so (``"spmd": false``).

The record's keys, against the reference's:

=============================  ==========================================
port                           reference
=============================  ==========================================
``counted_flops``              ``hlo_flops`` (per device x chips)
``counted_flops_per_device``   ``hlo_flops_per_device``: rank 0's count
                               (``spmd``), else the even split
``counted_bytes``              ``hlo_bytes`` (per device x chips)
``counted_bytes_per_device``   ``hlo_bytes_per_device``
``collective_bytes``           the same key: rank 0's collective operand
                               bytes x chips (null outside ``spmd``)
``collective_bytes_per_device``  the same key
``collectives``                the same key: rank 0's collectives under the
                               reference's op names
``memory``                     XLA's memory analysis: the argument bytes
                               one device holds, from the rules (each dim
                               over its spec's mesh axes, rounded up); no
                               temp, output or code sizes
``model_vs_counted_flops``     ``model_vs_hlo_flops``
``meta_run_s``                 ``lower_s`` and ``compile_s``
``top_ops``                    no counterpart: the ops moving most bytes
``probe``                      ``probe_l1`` / ``probe_l2`` / ``raw_scan_once``:
                               not run, and the record says why
=============================  ==========================================

``roofline["collective_s"]`` holds the collective bytes against
``hw.NVLINK_BW``. A (16, 16) mesh spans two 8-card nodes along ``model``,
so that axis's traffic crosses InfiniBand, slower than NVLink: the record's
``collective_note`` says so.

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
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, runnable
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    batch_specs, cache_specs, shard_opt_state, shard_params)
from repro_torch.launch import hw
from repro_torch.launch.hlo_stats import OpCounter
from repro_torch.launch.mesh import (argument_bytes, make_production_mesh,
                                     make_production_spmd_mesh)
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
LINK_NOTE = ("collective_s: rank 0's collective operand bytes x chips over NVLink 4 "
             "(hw.NVLINK_BW, 450 GB/s a card and direction); a (16, 16) mesh spans two "
             "8-card nodes along 'model', so that axis crosses InfiniBand, slower than "
             "this term assumes; collectives as DTensor issues them on a 'cuda' mesh")
#: The ROADMAP 14d item that ports each family's sharded program.
NEXT_SLICE = {"mla": "MLA (minicpm3)", "moe": "MoE with expert placement and all-to-all",
              "ssm": "SSM / hybrid / RWKV states", "hybrid": "SSM / hybrid / RWKV states",
              "encdec": "enc-dec and VLM", "vlm": "enc-dec and VLM"}


def spmd_family(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s sharded program is ported: the dense GQA decoders."""
    return cfg.family == "dense" and cfg.attn_type == "gqa" and not cfg.n_experts


def _outside_note(cfg: ArchConfig) -> str:
    key = cfg.attn_type if cfg.attn_type == "mla" else ("moe" if cfg.n_experts else cfg.family)
    return (f"null: the {cfg.family} family's sharded program is not ported (ROADMAP 14d, "
            f"{NEXT_SLICE.get(key, key)}); its counts are one card's eager count of the "
            "whole step split evenly over the chips")


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


def count_rank0(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Tuple[OpCounter, int, float]:
    """Rank 0's program of the cell on ``mesh`` (a fake-group
    :class:`~torch.distributed.device_mesh.DeviceMesh`), its arguments
    ``meta`` blocks placed by the rules. Returns (its :class:`OpCounter`,
    the argument bytes a device, seconds)."""
    fn, args, shardings = _step_and_specs(cfg, shape, spmd.RuleMesh(mesh))
    arg_bytes = argument_bytes(args, shardings)
    local = spmd.zeros_tree(args, shardings, mesh, device="meta")
    t0 = time.time()
    counter = count_step(fn, local)
    return counter, arg_bytes, time.time() - t0


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

    if spmd_family(cfg):
        with make_production_spmd_mesh(multi_pod=mesh_kind == "multi") as mesh:
            counter, arg_bytes, run_s = count_rank0(cfg, shape, mesh)
            chips = mesh.size()
        flops_dev, bytes_dev = float(counter.flops), float(counter.bytes)
        coll = counter.collectives
        coll_dev = float(coll["TOTAL"]["operand_bytes"])
        extra = dict(spmd=True, collective_bytes=coll_dev * chips,
                     collective_bytes_per_device=coll_dev, collectives=coll,
                     collective_note=LINK_NOTE)
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        chips = mesh.devices.size
        fn, args, shardings = _step_and_specs(cfg, shape, mesh)
        arg_bytes = argument_bytes(args, shardings)
        t0 = time.time()
        counter = count_step(fn, args)
        run_s = time.time() - t0
        flops_dev, bytes_dev = counter.flops / chips, counter.bytes / chips
        coll_dev = None
        extra = dict(spmd=False, collective_bytes=None, collective_bytes_per_device=None,
                     collectives=None, collective_note=_outside_note(cfg))
    print(f"[{arch} {shape_name} {mesh_kind}] argument bytes per device: {arg_bytes:,}")
    print(f"[{arch} {shape_name} {mesh_kind}] counted per device: "
          f"flops={flops_dev:.3e} bytes={bytes_dev:.3e} collective bytes={coll_dev}")

    flops, bytes_hbm = flops_dev * chips, bytes_dev * chips
    model_flops = _model_flops(cfg, shape)
    roofline = hw.roofline_terms(flops=flops, bytes_hbm=bytes_hbm,
                                 bytes_collective=(coll_dev or 0.0) * chips, chips=chips)
    if coll_dev is None:
        roofline["collective_s"] = None
    rec.update(
        status="ok",
        chips=chips,
        meta_run_s=round(run_s, 2),
        counted_flops=flops,
        counted_flops_per_device=flops_dev,
        counted_bytes=bytes_hbm,
        counted_bytes_per_device=bytes_dev,
        **extra,
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
                    coll = ("n/a" if r["collective_s"] is None
                            else f"{r['collective_s']:.4f}s")
                    print(
                        f"ok in {rec['meta_run_s']:.0f}s  compute {r['compute_s']:.4f}s"
                        f"  memory {r['memory_s']:.4f}s  collective {coll}"
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
