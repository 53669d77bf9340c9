"""Training launcher: ``make_train_step`` and a loop with checkpoint
auto-resume, watchdog, straggler stats and optional failure injection
(which drives the fault-tolerance path end to end).

Counterpart of ``repro.launch.train``. Where the reference differentiates
``loss_fn`` with ``jax.value_and_grad`` inside one jitted, donating step,
``train_step`` runs the port's ``loss_fn`` forward under autograd (each
layer under the config's remat policy), takes ``torch.autograd.grad`` over
the parameter leaves, and updates the parameters and the optimizer state in
place. The loop runs on the card unless the caller names another device.

Usage (CPU, reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tree import resolve_device
from repro_torch.data.lm_data import PrefetchingLoader
from repro_torch.distributed.fault import StepWatchdog, TransientError, run_with_retries
from repro_torch.distributed.spmd import program, replicated
from repro_torch.models import lm as lm_lib
from repro_torch.models.common import ArchConfig
from repro_torch.optim.optimizers import (
    Optimizer,
    ef_compress,
    ef_init,
    get_optimizer,
    match_placements,
    warmup_cosine,
)

log = logging.getLogger("repro_torch.train")


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, compress_grads: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    The parameters and the optimizer state are updated in place and
    returned. ``compress_grads``: error-feedback bf16 gradient compression
    (the payload an all-reduce between nodes would carry shrinks 2x); the
    residual lives in opt_state['ef'].

    The step runs as one program over a mesh when the parameters, the state
    and the batch are DTensors (placed by ``shard_params``,
    ``shard_opt_state`` and ``batch_specs``): under
    ``implicit_replication()``, with each gradient brought to its
    parameter's placements before it reaches the optimizer. The metrics come
    back as plain tensors, the same on every rank.
    """

    def train_step(params, opt_state, batch):
        with program(params):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        step = opt_state["inner"]["step"]
        lr = warmup_cosine(step, peak=peak_lr, warmup=warmup, total=total_steps)
        leaves, spec = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, metrics = lm_lib.loss_fn(cfg, tree_unflatten(live, spec), batch)
            flat = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        del live
        grads = match_placements(tree_unflatten(list(flat), spec), params)
        del flat
        if compress_grads:
            grads, res = ef_compress(grads, opt_state["ef"])
            grads = lm_lib._map(lambda g: g.float(), grads)
        new_params, new_inner = optimizer.update(grads, opt_state["inner"], params, lr)
        new_opt = {"inner": new_inner}
        if compress_grads:
            new_opt["ef"] = res
        metrics = dict(metrics, loss=loss, lr=lr)
        return new_params, new_opt, {k: replicated(v.detach()) for k, v in metrics.items()}

    return train_step


def init_opt_state(optimizer: Optimizer, params, *, compress_grads: bool = False):
    state = {"inner": optimizer.init(params)}
    if compress_grads:
        state["ef"] = ef_init(params)
    return state


def train_loop(
    cfg: ArchConfig,
    *,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: Optional[str] = None,
    save_every: int = 20,
    seed: int = 0,
    log_every: int = 10,
    inject_failure_at: Optional[int] = None,
    compress_grads: bool = False,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps on ``device`` (the card unless
    named; without one this raises). Parameters are drawn from a
    ``torch.Generator`` on that device seeded with ``seed``; with a
    checkpoint in ``ckpt_dir`` the loop resumes from its latest step."""
    dev = resolve_device(device)
    optimizer = get_optimizer(cfg.optimizer)
    step_fn = make_train_step(cfg, optimizer, total_steps=max(steps, 10),
                              warmup=max(2, steps // 10), compress_grads=compress_grads)

    params = lm_lib.init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    opt_state = init_opt_state(optimizer, params, compress_grads=compress_grads)
    start_step = 0

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        start_step, restored = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        log.info("resumed from step %d", start_step)

    loader = PrefetchingLoader(cfg, seed=seed, batch=batch, seq=seq,
                               start_step=start_step)
    watchdog = StepWatchdog()
    losses = []
    injected = {"done": inject_failure_at is None}

    try:
        for _ in range(start_step, steps):
            step_no, np_batch = next(loader)
            batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}

            def one_step():
                nonlocal params, opt_state
                if not injected["done"] and step_no == inject_failure_at:
                    injected["done"] = True
                    raise TransientError(f"injected failure at step {step_no}")
                watchdog.start()
                params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
                loss = float(metrics["loss"])  # waits for the step
                watchdog.stop()
                losses.append(loss)
                if step_no % log_every == 0:
                    log.info("step %d loss %.4f lr %.2e", step_no, loss, float(metrics["lr"]))

            def on_retry(attempt, err):
                nonlocal params, opt_state
                if ckpt and ckpt.latest_step() is not None:
                    _, restored = ckpt.restore({"params": params, "opt": opt_state})
                    params, opt_state = restored["params"], restored["opt"]
                    log.info("restored from checkpoint after %s", err)

            run_with_retries(one_step, on_retry=on_retry)

            if ckpt and (step_no + 1) % save_every == 0:
                ckpt.save(step_no + 1, {"params": params, "opt": opt_state})
    finally:
        loader.close()
        if ckpt:
            ckpt.wait()

    return {
        "losses": losses,
        "watchdog": watchdog.summary(),
        "final_params": params,
        "steps_run": len(losses),
    }


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; 'cpu' to run here)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    out = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        inject_failure_at=args.inject_failure_at,
        compress_grads=args.compress_grads, device=args.device,
    )
    print(f"ran {out['steps_run']} steps; "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; "
          f"watchdog {out['watchdog']}")


if __name__ == "__main__":
    main()
