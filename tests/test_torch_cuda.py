"""PyTorch port on a GPU: the CUDA kernel and the traversal on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without one
(from its fixture). The file imports nothing of JAX, so it runs on a GPU
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The kernel is held against its plain version; the traversal on the card
against the same traversal on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.tree import XMRTree
from repro_torch.kernels import mscm_kernel as tk
from repro_torch.sparse.csr import random_sparse_csc, random_sparse_csr

# R-term f32 sums in different orders (see chip_smoke.py).
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is true f32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(640, 8, 496, 32, 300), (1, 4, 8, 6, 3), (3, 16, 100, 70, 4)])
def test_kernel_matches_plain(cuda_device, shape):
    t, qt, r, b, c = shape
    g = torch.Generator().manual_seed(0)
    xg = torch.rand(t, qt, r, generator=g).to(cuda_device)
    vals = torch.randn(c, r, b, generator=g).to(cuda_device)
    tc = torch.sort(torch.randint(0, c, (t,), generator=g)).values.to(cuda_device)
    ps = torch.rand(t, qt, generator=g).to(cuda_device)
    for mode in ("none", "prod", "logsum"):
        p = None if mode == "none" else ps
        before = tk.GROUPED_LAUNCHES
        got = tk.mscm_grouped(xg, vals, tc, p, mode=mode)
        assert tk.GROUPED_LAUNCHES == before + 1
        want = tk.mscm_grouped_plain(xg, vals, tc, p, mode=mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("score_mode", ["prod", "logsum"])
def test_traversal_on_card_matches_cpu(cuda_device, score_mode):
    rng = np.random.default_rng(1234)
    d, B = 150, 8
    ws = [random_sparse_csc(d, L, 10, rng, sibling_groups=B) for L in (8, 64, 512)]
    x = random_sparse_csr(12, d, 18, rng)
    xi, xv = (torch.from_numpy(a) for a in x.to_ell())
    cpu = XMRTree.from_weight_matrices(ws, B, device="cpu")
    gpu = XMRTree.from_weight_matrices(ws, B)  # the default device is the GPU
    assert gpu.device.type == "cuda"
    s0, l0 = cpu.infer(xi, xv, beam=10, topk=5, method="mscm_dense", score_mode=score_mode)
    before = tk.GROUPED_LAUNCHES
    s1, l1 = gpu.infer(xi, xv, beam=10, topk=5, method="mscm_pallas_grouped",
                       score_mode=score_mode, qt=4)
    assert tk.GROUPED_LAUNCHES == before + gpu.depth
    torch.testing.assert_close(s1.cpu(), s0, rtol=1e-5, atol=1e-6)
    assert torch.equal(l1.cpu(), l0)
