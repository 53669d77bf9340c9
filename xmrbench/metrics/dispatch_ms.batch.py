"""Host time of ``serve.run`` (everything the traversal enqueues) a query in the traced batch calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.host(rec, "batch", "serve.run")
