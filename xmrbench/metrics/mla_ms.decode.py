"""Device interval of the attention's spans (``mla.decode``) a decode step in the traced steps, in ms."""

from xmrbench import spans


def read(rec):
    per_token = spans.device(rec, "decode", "mla.decode")
    return None if per_token is None else per_token * rec.traced_queries / rec.traced_calls
