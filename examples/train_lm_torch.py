"""Train a reduced LM of one of the assigned architectures on the PyTorch
port, through the whole training loop: prefetching data pipeline, the
config's optimizer with a warmup-cosine schedule, asynchronous checkpoints,
auto-resume, an injected failure and its retry, and error-feedback gradient
compression.

The counterpart of ``examples/train_lm.py``, through ``repro_torch`` only (no
JAX):

    PYTHONPATH=src python examples/train_lm_torch.py [--arch hymba-1.5b] [--steps 200]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # on the CPU
"""

import argparse
import logging
import shutil
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.train import train_loop


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; 'cpu' to run without)")
    args = ap.parse_args()

    cfg = reduced_config(get_config(args.arch))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_lm_")
    print(f"training reduced {cfg.name} ({cfg.family}) for {args.steps} steps; "
          f"checkpoints -> {ckpt_dir}")

    out = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=ckpt_dir, save_every=50,
        inject_failure_at=args.steps // 2,   # prove the retry/restore path
        compress_grads=True, device=args.device,
    )
    losses = out["losses"]
    print(f"\nloss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({out['steps_run']} steps on {out['final_params']['embed'].device}, failure "
          f"injected+recovered at {args.steps // 2})")
    print("watchdog:", out["watchdog"])
    if losses[-1] >= losses[0]:
        raise SystemExit("the loss should fall on the synthetic corpus")
    if args.ckpt_dir is None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
