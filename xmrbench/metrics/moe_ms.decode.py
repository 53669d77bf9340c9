"""Device interval of the MoE layers' spans (``moe.route``, ``moe.routed``, ``moe.shared``) a decode step in the traced steps, in ms."""

from xmrbench import spans

NAMES = ("moe.route", "moe.routed", "moe.shared")


def read(rec):
    per_token = spans.device(rec, "decode", *NAMES)
    return None if per_token is None else per_token * rec.traced_queries / rec.traced_calls
