"""The window's seconds over the solves completed in it, in ms: the mean
time to solution.  Its runs spread too widely on the card's shared host to
hold a bound (PERF.md §2), so it stands here beside ``cg_solve_p95_ms``."""


def read(ctx):
    win = ctx.get("window", {})
    if not win.get("attempted"):
        return None
    return win["elapsed_s"] / win["attempted"] * 1e3
