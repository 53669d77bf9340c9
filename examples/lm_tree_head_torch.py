"""MSCM vocab-tree head on an LM's output layer, on the PyTorch port:
sub-linear decode over the vocabulary. The counterpart of
``examples/lm_tree_head.py``, through ``repro_torch`` only (no JAX).

Partitions a dense lm_head (d = 1,024, V = 65,536) into a 2-level chunked
tree and shows (a) exactness at full beam, (b) agreement at practical
beams, (c) latency, timed with CUDA events on the card.

    PYTHONPATH=src python examples/lm_tree_head_torch.py                # on the card
    PYTHONPATH=src python examples/lm_tree_head_torch.py --device cpu   # on the CPU
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.tree import resolve_device
from repro_torch.models.xmr_head import VocabTreeHead, greedy_token

BEAMS = (4, 16, 64)


def structured_head(generator: torch.Generator, d: int, vocab: int, branching: int):
    """Head weights [d, V] with real-embedding-like cluster geometry, drawn
    on the generator's device: tokens in a chunk share a centroid (random
    heads have meaningless centroids and defeat any routing; real LM heads
    are strongly clustered)."""
    dev = generator.device
    c = (vocab + branching - 1) // branching
    centers = torch.randn((c, d), generator=generator, device=dev) / np.sqrt(d)
    noise = torch.randn((c, branching, d), generator=generator, device=dev) / np.sqrt(d)
    w = centers[:, None, :] + 0.4 * noise                 # [C, B, d]
    return w.reshape(c * branching, d)[:vocab].T          # [d, V]


def timed_ms(fn, dev: torch.device, reps: int = 10) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm call: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def evaluate(head_w: torch.Tensor, hidden: torch.Tensor, branching: int) -> dict:
    """The tree head of ``head_w`` [d, V] against its dense argmax over
    ``hidden`` [n, d], on their device: full-beam exactness, then each
    beam's tokens, agreement and time. Returns ``{"exact": share,
    "dense_ms": ms, beam: (tokens, agreement, ms)}``."""
    dev = hidden.device
    tree = VocabTreeHead.from_lm_head(head_w, branching)
    print(f"vocab {head_w.shape[1]:,} -> {tree.n_clusters} chunks of {branching} on {dev}")

    def dense():
        return torch.argmax(hidden @ head_w, dim=1)

    full = dense()
    exact = greedy_token(tree, hidden, beam=tree.n_clusters)
    out = {"exact": float((exact == full).float().mean())}
    print(f"full-beam exactness: {out['exact']:.3f} (must be 1.0)")

    out["dense_ms"] = t_dense = timed_ms(dense, dev)
    for beam in BEAMS:
        tokens = greedy_token(tree, hidden, beam=beam)
        t = timed_ms(lambda b=beam: greedy_token(tree, hidden, beam=b), dev)
        agree = float((tokens == full).float().mean())
        out[beam] = (tokens, agree, t)
        print(f"beam {beam:3d}: {1e3 * t:8.1f} us  (dense {1e3 * t_dense:.1f} us, "
              f"{t_dense / t:4.1f}x)  argmax agreement {agree:.3f}")
    if dev.type == "cuda":
        print(f"on {torch.cuda.get_device_name(dev)}")
    return out


def run(device=None, d: int = 1024, vocab: int = 65_536, branching: int = 128,
        n: int = 16, seed: int = 0) -> dict:
    """:func:`evaluate` on a structured head and hidden states drawn on
    ``device`` (the card unless named) from a generator seeded ``seed``."""
    g = torch.Generator(resolve_device(device)).manual_seed(seed)
    head_w = structured_head(g, d, vocab, branching)
    hidden = torch.randn((n, d), generator=g, device=g.device)
    return evaluate(head_w, hidden, branching)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run without)")
    args = ap.parse_args()
    out = run(args.device)
    if out["exact"] != 1.0:
        raise SystemExit("the full-beam tree head must reproduce the dense argmax")


if __name__ == "__main__":
    main()
