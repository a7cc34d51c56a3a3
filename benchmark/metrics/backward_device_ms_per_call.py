"""Device milliseconds of a density call's backward pass in the profiled
solve: the summed device extents of the ``density.backward`` spans over
their count."""

from benchmark.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    ms, n = spans.device_ms(recs, "density.backward"), spans.count(recs, "density.backward")
    return ms / n if ms is not None and n else None
