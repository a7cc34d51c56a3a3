"""Device milliseconds a density call outside the evidence kernel, in the
profiled solve: the aux closure, bijectors, priors, whitening and the
samplers' updates."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.calls or not tr.evidence_s:
        return None
    return 1e3 * (tr.device_s - sum(tr.evidence_s)) / tr.calls
