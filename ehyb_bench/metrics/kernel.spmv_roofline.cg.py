"""The permuted-space apply's share of its floor: the least time any
implementation of one apply could take (``floors.apply_floor_s``) over its
CUDA-event time, back to back, in %."""


def read(ctx):
    ms = ctx.get("event_ms", {}).get("permuted")
    if not ms:
        return None
    return ctx["floor_apply_s"] / (ms / 1e3) * 100.0
