"""Queries a second served by back-to-back serve_batch calls over the window (host clock)."""

from xmrbench import readers


def read(rec):
    return readers.rate(rec, "batch")
