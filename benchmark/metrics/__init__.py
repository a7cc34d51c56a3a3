"""One reader per metric: ``read(ctx)`` returns the metric's value, or
None where the run holds nothing for it to read. ``ctx`` is built by
``benchmark/run.py`` after the window: ``cfg`` (the configuration's JSON),
``dtype``, ``setup_s``, ``window_s``, ``units`` (the window's solves or
requests), ``stats`` (per unit, the generator's own numbers: for a solve
``min_ess``, ``max_rhat``, ``divergences``, ``wall_s``, ``passed``), the
generator's counters over the window (for a solve ``calls``, the program's
density-call counters, and ``rows``, chain-evaluations at
``log_marginal_batch``), ``trace`` (`benchmark.lib.trace.Trace` of the
profiled unit, or None) and ``card``."""
