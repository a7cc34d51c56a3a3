"""Milliseconds of the unprofiled window per batched density call."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.calls if ctx.calls else None
