"""Seconds from the start of the process to the end of the warm-up solve."""


def read(ctx):
    return ctx.setup_s
