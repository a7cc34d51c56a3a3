"""Batched density calls a solve (the program's counters of evidence-kernel
launches, plain calls and route calls, over the unprofiled window)."""


def read(ctx):
    return ctx.calls / ctx.units if ctx.calls else None
