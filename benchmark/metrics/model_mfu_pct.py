"""The whole solve's share of the card's FP64 (or FP32) peak, in percent:
the evidence's flops per chain-evaluation with its gradient
(`benchmark.lib.roofline.flops_per_chain`) times the chain-evaluations of
the unprofiled window, over its length and the data sheet's peak. The
warp's and the mean's O(N) flops are not counted."""

from benchmark.lib.roofline import PEAK_FLOPS, flops_per_chain


def read(ctx):
    if not ctx.rows:
        return None
    ev = ctx.cfg["evidence"]
    flops = flops_per_chain(ev["kind"], ev["n"]) * ctx.rows
    return 100.0 * flops / ctx.window_s / PEAK_FLOPS[ctx.dtype]
