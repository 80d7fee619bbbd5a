"""The whole original-space apply ``op @ x`` (permutations, kernel and
copies) as a share of the floor of one apply: floor seconds over its
CUDA-event time, back to back, in %."""


def read(ctx):
    ms = ctx.get("event_ms", {}).get("original")
    if not ms:
        return None
    return ctx["floor_apply_s"] / (ms / 1e3) * 100.0
