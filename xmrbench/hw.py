"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W).

The benchmark's own copy: every share of a peak or a roofline divides by
these numbers, so a change to the program cannot move them."""

HBM_BW = 3.35e12          # bytes/s: HBM3
PEAK_FLOPS_F32 = 67e12    # FLOP/s: float32 outside the tensor cores


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the compute and the
    memory term."""
    return max(flops / PEAK_FLOPS_F32, nbytes / HBM_BW)
