"""The api layer's share of ``op @ x``: (t(op @ x) - t(permuted apply)) /
t(op @ x), CUDA events, back to back, in %."""


def read(ctx):
    ev = ctx.get("event_ms", {})
    if not ev.get("original") or not ev.get("permuted"):
        return None
    return (ev["original"] - ev["permuted"]) / ev["original"] * 100.0
