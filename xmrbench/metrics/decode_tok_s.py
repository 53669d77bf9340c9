"""Tokens decoded in the window (sequences x decode steps) over its seconds (host clock)."""

from xmrbench import readers


def read(rec):
    return readers.rate(rec, "decode")
