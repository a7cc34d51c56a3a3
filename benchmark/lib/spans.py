"""The program's own span records of the profiled solve
(`gptools_tpu_torch.utils.metrics.last_solve`): a profiler session turns the
program's recording on, so after a traced run the last recorded solve is
the profiled one. Every reader of a span or counter metric goes through
`records`, which gives None where there is nothing to read: an untraced
run, or a program without spans."""

from __future__ import annotations

from typing import Optional


def records(ctx) -> Optional[list]:
    """``ctx.spans`` where the run gives them, else the program's last
    recorded solve in a traced run; None if there is none."""
    recs = getattr(ctx, "spans", None)
    if recs is None:
        if getattr(ctx, "trace", None) is None:
            return None
        try:
            from gptools_tpu_torch.utils import metrics
        except ImportError:
            return None
        last = getattr(metrics, "last_solve", None)
        recs = last() if last is not None else None
    return recs or None


def named(recs: list, name: str) -> list:
    return [r for r in recs if r["name"] == name]


def count(recs: list, name: str) -> int:
    return sum(r["name"] == name for r in recs)


def device_ms(recs: list, name: str) -> Optional[float]:
    """Σ the device extents of the spans ``name``; None if none has one."""
    ext = [r.get("device_ms") for r in named(recs, name)]
    ext = [e for e in ext if e is not None]
    return sum(ext) if ext else None


def counters(recs: list) -> Optional[dict]:
    """The root's counters: their deltas over the solve."""
    roots = [r for r in recs if r.get("parent") is None and r["name"] == "solve"]
    if len(roots) != 1:
        return None
    return roots[0].get("attrs", {}).get("counters")
