"""Host time blocked on the device (``serve.wait``) a query in the traced batch calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.host(rec, "batch", "serve.wait")
