"""Host time of ``serve.run`` (everything the traversal enqueues) a query in the traced online calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.host(rec, "online", "serve.run")
