"""Device interval of the lookup tables' fill and scatter (``mscm.table``) a query in the traced online calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.device(rec, "online", "mscm.table")
