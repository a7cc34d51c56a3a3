"""The window's length over its solves: the wall a user waits for one
posterior."""


def read(ctx):
    return ctx.window_s / ctx.units
