"""Share of the profiled solve's span in which no device op runs (the
union of the device's intervals on the timeline), in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
