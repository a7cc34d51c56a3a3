"""Share of the profiled solve's device extent (the time between the CUDA
events at its boundaries) spent in its SMC warm start
(``solve.warm_start`` over ``solve``), in percent."""

from benchmark.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    part, whole = spans.device_ms(recs, "solve.warm_start"), spans.device_ms(recs, "solve")
    if part is None or not whole:
        return None
    return 100.0 * part / whole
