"""The MoE layers' counted work in the traced decode steps (kinds/lm_moe_decode.py moe_work: the router, the touched experts, the shared experts) at the chip's peaks over the device interval of their spans, in %."""

from xmrbench import hw, spans

NAMES = ("moe.route", "moe.routed", "moe.shared")


def read(rec):
    moe = getattr(rec.traced_work, "moe", None)
    per_token = spans.device(rec, "decode", *NAMES)
    if moe is None or not per_token:
        return None
    seconds = per_token * rec.traced_queries * 1e-3
    return 100.0 * hw.least_seconds(moe.flops, moe.nbytes) / seconds
