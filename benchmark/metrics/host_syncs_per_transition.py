"""Blocking device-to-host reads of the profiled solve (the growth of the
program's ``HOST_SYNCS``, every site) over its ChEES transitions
(``chees.transition`` spans)."""

from benchmark.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    if recs is None:
        return None
    counts, n = spans.counters(recs), spans.count(recs, "chees.transition")
    if not counts or "host_syncs" not in counts or not n:
        return None
    return sum(counts["host_syncs"].values()) / n
