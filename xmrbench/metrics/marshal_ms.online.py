"""Host time of ``serve.marshal`` (ELL rows, padding, pinning, the copy's enqueue) a query in the traced online calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.host(rec, "online", "serve.marshal")
