"""Device milliseconds a density call in the profiled solve: the summed
device extents of the ``density`` spans and of their backward passes
(``density.backward``), over the ``density`` spans. An extent includes the
device's idle time while the host was inside the span."""

from benchmark.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    fwd, n = spans.device_ms(recs, "density"), spans.count(recs, "density")
    if fwd is None or not n:
        return None
    return (fwd + (spans.device_ms(recs, "density.backward") or 0.0)) / n
