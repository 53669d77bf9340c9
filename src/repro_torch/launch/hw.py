"""Target-hardware constants (one NVIDIA H100 SXM) for roofline terms.

Counterpart of ``repro.launch.hw``, whose constants are a TPU v5e's. The
rates are NVIDIA's H100 SXM data sheet figures (dense, no sparsity) at the
card's full 700 W power limit; a card set below it runs slower under load.
"""

HBM_BW = 3.35e12            # bytes/s per card: HBM3 (data sheet, SXM)
PEAK_FLOPS_F32 = 67e12      # FLOP/s per card, f32 outside the tensor cores (data sheet)
NVLINK_BW = 450e9           # bytes/s per card and direction: NVLink 4, 900 GB/s both ways


def roofline_terms(*, flops: float, bytes_hbm: float, bytes_collective: float,
                   chips: int) -> dict:
    """The three per-step roofline times (seconds) + dominant term.

    Compute is held against the f32 rate: the port keeps every matrix
    product in true f32 (TF32 off), as the reference's f32 parameters ask.
    """
    t_compute = flops / (chips * PEAK_FLOPS_F32)
    t_memory = bytes_hbm / (chips * HBM_BW)
    t_collective = bytes_collective / (chips * NVLINK_BW)
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
    }
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = terms[dom]
    return terms
