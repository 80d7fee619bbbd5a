"""CUDA kernels launched in the profiled solves over their iterations: the
host's share of each iteration, counted in launches."""


def read(ctx):
    prof = ctx.get("profile", {})
    iters = prof.get("info", {}).get("iters")
    if not prof.get("kernels") or not iters:
        return None
    return prof["kernels"] / iters
