"""Device activities (kernels, copies, memsets) a query in the traced online calls."""

from xmrbench import readers


def read(rec):
    return readers.activities_per_query(rec, "online")
