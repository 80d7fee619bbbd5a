"""The device's idle share of the profiled window: 1 - the union of the
device operations' intervals over the window's host-clock length, in %."""


def read(ctx):
    prof = ctx.get("profile", {})
    if not prof.get("busy_s"):
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
