"""Share of the traced decode steps' window with no device activity, in %."""

from xmrbench import readers


def read(rec):
    return readers.idle_share(rec, "decode")
