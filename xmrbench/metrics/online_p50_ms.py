"""Median client-timed serve_online call over the window, in ms (host clock)."""

from xmrbench import readers


def read(rec):
    return readers.latency_ms(rec, "online", 50)
