"""Read the check's numbers over many seeds in one process: the program's
(the lower readings), the control's (the upper readings) and, for the
record, each fault's. Not part of a benchmark run.

    python3 xmrbench/calibrate.py --workload <cell> --seeds <first>:<count> \\
        [--control-seeds <first>:<count>] [--faults] [--seconds 2]

Each run sets the cell up from its seed at full size and drives a short
window at the cell's own load; one JSON line a run on standard output, a
summary at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import _paths  # noqa: E402


def _seeds(spec: str):
    first, count = (int(x) for x in spec.split(":"))
    return [first + i * 7919 for i in range(count)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from xmrbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    hooks = harness.load_kind(cell.config.get("kind", harness.DEFAULT_KIND), cell.kinds)
    runs = [(s, "program", None) for s in _seeds(args.seeds)]
    if args.control_seeds:
        runs += [(s, "control", hooks.control_hook()) for s in _seeds(args.control_seeds)]
    if args.faults:
        seed = _seeds(args.seeds)[0]
        runs += [(seed, f, hook) for f, hook in hooks.fault_hooks(cell.mix).items()]
    summary = {}
    for seed, kind, hook in runs:
        t0 = time.perf_counter()
        result, checks = harness.run_cell(cell, seed, args.seconds, False, device="cuda",
                                          t_start=t0, engine_hook=hook)
        line = {"cell": cell.name, "seed": seed, "kind": kind, "correct": result["correct"],
                "attempted": result["attempted"], "failed": result["failed"],
                "checks": {n: v for n, (v, _) in checks.items()},
                "seconds": round(time.perf_counter() - t0, 3)}
        print(json.dumps(line), flush=True)
        for n, (v, _) in checks.items():
            summary.setdefault(kind, {}).setdefault(n, []).append(v)
        torch.cuda.empty_cache()
    for kind, checks in summary.items():
        print(json.dumps({"kind": kind, "min": {n: min(v) for n, v in checks.items()},
                          "max": {n: max(v) for n, v in checks.items()}}), flush=True)
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
