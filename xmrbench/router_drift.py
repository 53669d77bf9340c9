"""The router's drift between the program and the plain reference on the
``lm_moe_decode`` kind's judged tokens: the reading that its check's
``tie_margin`` is set from (``PERF.md``).

    python3 xmrbench/router_drift.py --workload dsv2lite-decode-8k --seeds 11 12 13

For each seed: the cell's set-up (weights, prompts, prefill), then the
batch's decode steps of round 0 up to its last judged step, eagerly, each
MoE layer's router logits of the judged sequences kept (the input of
``models.moe._route`` times the router, in float32); and the reference's
router logits at the same rows (``lm_moe_reference._moe``'s input times the
router). A token's drift in a layer is how far the program moves the
layer's routing margin: with ``S`` the reference's top-K and ``C`` the
other experts, ``|(min_S p - max_C p) - (min_S r - max_C r)|`` for the
program's logits ``p`` and the reference's ``r``; the program keeps the
reference's top-K exactly where its own margin ``min_S p - max_C p`` stays
above 0. The drift is read in each layer up to the first whose top-K
differs (a flip changes what every later layer sees); the flips are
counted, with the routing margin of each flipped token. Per judged token it keeps
the logit gap (as the check reads it), the routing margin, and each layer's
reference margin and signed drift, so that a ``tie_margin`` can be tried
against them. One JSON line a seed, on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from xmrbench import harness, lm_moe_reference  # noqa: E402
from xmrbench.kinds import lm_moe_decode  # noqa: E402


def drift(run) -> dict:
    """The readings of one set-up ``run`` (see the module's docstring)."""
    from repro_torch.models import lm, moe

    k = run.cfg.experts_per_token
    steps, seqs = run.judge_steps, run.judge_seqs
    prog_router = {}                      # step -> [layer][B, E]
    prog_logits = {}
    route = moe._route

    def probe(p, x2d, cfg):
        prog_router.setdefault(current[0], []).append((x2d.float() @ p["router"].float()))
        return route(p, x2d, cfg)
    current = [None]
    moe._route = probe
    try:
        with torch.no_grad():
            for j in range(steps[-1] + 1):
                current[0] = j
                out, _ = lm.decode_step(run.cfg, run.w, run.cache, run.answers[0, j],
                                        run.prompt_len + j)
                prog_logits[j] = out.float()
    finally:
        moe._route = route

    ref_router = []
    forward_moe = lm_moe_reference._moe

    def ref_probe(h, f, model, dtype, swap=()):
        ref_router.append((h[rows_t] @ f["router"]).float())
        return forward_moe(h, f, model, dtype, swap)
    tokens = []
    lm_moe_reference._moe = ref_probe
    try:
        for b in seqs:
            rows = [run.prompt_len + j for j in steps]
            rows_t = torch.as_tensor(rows, device=run.dev)
            ref_router.clear()
            ref, margin = lm_moe_reference.forward(run.w, run.model, run._sequence(b, 0, steps[-1]),
                                                   rows, with_margins=True)
            for n, j in enumerate(steps):
                prog = prog_logits[j][b]
                gap = float((prog - ref[n]).abs().max() / (1.0 + ref[n].abs().max()))
                widest, flipped_at, layers = 0.0, None, []
                for layer, (p_l, r_l) in enumerate(zip(prog_router[j], ref_router)):
                    pl, rl = p_l[b], r_l[n]
                    top = torch.zeros_like(rl, dtype=torch.bool)
                    top[rl.topk(k).indices] = True
                    mp = pl[top].min() - pl[~top].max()
                    mr = rl[top].min() - rl[~top].max()
                    widest = max(widest, float((mp - mr).abs()))
                    layers.append((float(mr), float(mp - mr)))
                    if mp <= 0:
                        flipped_at = layer
                        break
                tokens.append({"seq": b, "step": j, "gap": gap, "margin": float(margin[n].min()),
                               "drift": widest, "flipped_at": flipped_at, "layers": layers})
    finally:
        lm_moe_reference._moe = forward_moe
    return {
        "tokens": len(tokens),
        "widest_drift": max(t["drift"] for t in tokens),
        "flips": sum(t["flipped_at"] is not None for t in tokens),
        "flipped_margins": sorted(t["margin"] for t in tokens if t["flipped_at"] is not None),
        "per_token": tokens,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="dsv2lite-decode-8k")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = lm_moe_decode.setup(cell.config, cell.mix, seed, 0.0, False, device=args.device)
        out = drift(run)
        out.update(seed=seed, touched=run.touched, seconds=time.perf_counter() - t0)
        run.release()
        del run
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
