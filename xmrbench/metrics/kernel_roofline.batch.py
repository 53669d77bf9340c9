"""The MSCM kernels' counted work at the peaks over their device time in the traced batch calls, in %."""

from xmrbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "batch")
