"""Host time of ``serve.marshal`` (ELL rows, padding, pinning, the copy's enqueue) a query in the traced batch calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.host(rec, "batch", "serve.marshal")
