"""Host time blocked on the device (``serve.wait``) a query in the traced online calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.host(rec, "online", "serve.wait")
