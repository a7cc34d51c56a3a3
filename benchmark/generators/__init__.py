"""Traffic generators, one module each, found by the name a mix gives
under ``"generator"`` (``traffic/<mix>.json``).

A generator module has a class ``Session(spec, cfg, cfg_mod, config_name,
device, seed, program_hook=None)``. Building it is the run's set-up: the
program's model and data from the configuration, and the warm-up of every
shape the mix's traffic uses. Its methods:

- ``window(seconds, seed) -> Window``: the timed window; the generator owns
  its loop (solves back to back, or requests on an open loop) and closes it
  by the clock;
- ``profile(seed) -> benchmark.lib.trace.Trace``: one more unit of the
  window's work under the profiler, after the window;
- ``release()``: frees the program's state before the check;
- ``stats(records) -> list[dict]``: each unit's own numbers, with
  ``"passed"`` for its quality gates; the run logs every key;
- ``readings(records, seed, cell) -> dict``: the numbers that decide
  ``correct``, each a largest gap, judged against ``cells/<cell>.json``.

A mix that a generator already reads is a data file alone.
"""

from typing import NamedTuple


class Window(NamedTuple):
    records: list            # what each unit produced, in order
    window_s: float          # the window's true length
    counters: dict           # the program's counters over the window
    walls: list              # each unit's wall, in order
