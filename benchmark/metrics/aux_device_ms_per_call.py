"""Device milliseconds a density call spends forming the evidence kernel's
aux inputs (the mean, the noise, the input warp) in the profiled solve:
the summed device extents of the ``density.aux`` spans over the
``density`` spans."""

from benchmark.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    ms, n = spans.device_ms(recs, "density.aux"), spans.count(recs, "density")
    return ms / n if ms is not None and n else None
