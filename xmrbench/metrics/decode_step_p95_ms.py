"""95th percentile of the window's client-timed decode steps (one step of the whole batch), in ms (host clock)."""

from xmrbench import readers


def read(rec):
    return readers.latency_ms(rec, "decode", 95)
