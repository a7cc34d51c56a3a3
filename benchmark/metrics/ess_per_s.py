"""Sum over the window's solves that pass the quality gates of the least
ESS over theta's parameters, over the window's length."""


def read(ctx):
    return sum(s["min_ess"] for s in ctx.stats if s["passed"]) / ctx.window_s
