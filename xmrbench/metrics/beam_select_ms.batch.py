"""Device interval of the beam selects (``tree.beam_select``, ``plan.gather_select``) a query in the traced batch calls, in ms."""

from xmrbench import spans


def read(rec):
    return spans.device(rec, "batch", "tree.beam_select", "plan.gather_select")
