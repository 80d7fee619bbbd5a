"""The whole solve's share of the floor: the window's iterations times the
least time of one CG iteration (``floors.cg_iter_floor_s``) over the
window's solve seconds, call to result on the host, in %."""


def read(ctx):
    win = ctx.get("window", {})
    if not win.get("iters"):
        return None
    return (sum(win["iters"]) * ctx["floor_iter_s"]
            / sum(win["latencies_s"]) * 100.0)
