"""Theta rows a density call in the profiled solve: the growth of the
program's ``evidence_cuda.ROWS`` (rows reaching ``log_marginal_batch``, by
any route) over the ``density`` spans."""

from benchmark.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    counts, n = spans.counters(recs), spans.count(recs, "density")
    if not counts or "rows" not in counts or not n:
        return None
    return sum(counts["rows"].values()) / n
