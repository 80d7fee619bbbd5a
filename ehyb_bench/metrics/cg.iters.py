"""The mean of the window's ``SolveResult.iters``."""


def read(ctx):
    iters = ctx.get("window", {}).get("iters")
    return sum(iters) / len(iters) if iters else None
