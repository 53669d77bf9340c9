"""The window's decode steps' counted work (kinds/lm_decode.py decode_work) at the chip's peaks over the window's seconds, in %."""

from xmrbench import readers


def read(rec):
    return readers.mfu(rec, "decode")
