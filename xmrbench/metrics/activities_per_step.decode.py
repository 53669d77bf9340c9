"""Device activities (kernels, copies, memsets) a decode step in the traced steps."""

from xmrbench import readers


def read(rec):
    return readers.activities_per_call(rec, "decode")
