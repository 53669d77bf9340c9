"""Device interval of the lookup tables' fill and scatter (``mscm.table``) a query in the traced batch calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.device(rec, "batch", "mscm.table")
