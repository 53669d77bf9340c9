"""Quickstart on the PyTorch port: the full XMR pipeline on one GPU.

The counterpart of ``examples/quickstart.py``, at its sizes, through
``repro_torch`` only (no JAX): a synthetic product-search-like dataset
(512 labels, d = 1024), labels clustered (PIFA + balanced bisection), the
per-level rankers trained on the card, sparsified to 64 nonzeros a column,
then served with ``method="auto"`` (the grouped CUDA kernel on a GPU) and
every exact method, each checked to return the same labels.

    PYTHONPATH=src python examples/quickstart_torch.py         # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --cpu   # on the CPU
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.data import synthetic_labeled_dataset
from repro_torch.metrics import precision_at_k
from repro_torch.parity import check_ranking
from repro_torch.serving import ServeConfig, XMRServingEngine
from repro_torch.trees.train import train_xmr_model

METHODS = ("vanilla", "mscm_dense", "mscm_searchsorted", "mscm_pallas",
           "mscm_pallas_grouped")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="train and serve on the CPU (the kernels' plain versions)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None  # None: the GPU, or an error without one
    rng = np.random.default_rng(0)
    print("1) generating synthetic dataset (512 labels, d=1024) ...")
    ds = synthetic_labeled_dataset(
        rng, n_labels=512, d=1024, n_train=2048, n_test=512, query_nnz=20
    )

    print("2) clustering + training per-level rankers (branching 8) ...")
    t0 = time.perf_counter()
    model = train_xmr_model(
        ds.x_train, ds.y_train, ds.n_labels, branching=8, rng=rng,
        nnz_per_col=64, steps=150, device=device,
    )
    print(f"   trained on {model.tree.device} in {time.perf_counter() - t0:.1f}s; "
          f"model memory {model.tree.memory_bytes() / 1e6:.1f} MB")

    print("3) serving the test split with each masked-matmul method:")
    ref = None
    for method in ("auto",) + METHODS:
        eng = XMRServingEngine(model.tree, ServeConfig(beam=16, topk=5, ell_width=64,
                                                       method=method),
                               label_perm=model.structure.label_perm, device=device)
        eng.serve_batch(ds.x_test)  # warm
        t0 = time.perf_counter()
        scores, labels = eng.serve_batch(ds.x_test)
        dt = (time.perf_counter() - t0) / len(ds.y_test)
        if ref is None:
            ref = scores, labels
        swaps = check_ranking(scores, labels, *ref, f"{method} vs auto")
        p1 = precision_at_k(labels, ds.y_test, 1)
        name = f"auto ({eng.method})" if method == "auto" else method
        print(f"   {name:34s} P@1={p1:.3f}  {1e6 * dt:8.1f} us/query  "
              f"[same labels as auto; {swaps} near-tie swaps]")
    if not args.cpu:
        print(f"   on {torch.cuda.get_device_name(0)}")
    print("\nEvery method returns the same ranking (the paper's 'free of charge'"
          " property).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
