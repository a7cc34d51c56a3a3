"""The evidence kernel's share of its roofline in the profiled solve: the
least time of each launch at its own width (`benchmark.lib.roofline`),
summed, over the launches' summed device time, in percent. Each density
call is one launch; where the counts differ the kernel was not on the
path of every call, and nothing is read."""

from benchmark.lib.roofline import launch_bound_s


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.evidence_s or len(tr.evidence_s) != len(tr.widths):
        return None
    ev = ctx.cfg["evidence"]
    bound = sum(launch_bound_s(ev, c, ctx.dtype) for c in tr.widths)
    return 100.0 * bound / sum(tr.evidence_s)
