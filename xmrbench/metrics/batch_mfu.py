"""The batch window's counted work (work.py) at the chip's peaks over the window's seconds, in %."""

from xmrbench import readers


def read(rec):
    return readers.mfu(rec, "batch")
