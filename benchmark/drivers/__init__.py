"""General traffic drivers. A mix (``traffic/<mix>.json``) names its
driver and holds its parameters. Each driver has the same interface:

- ``setup(cell, seed, device, svm_overrides=None) -> state``: inputs
  made from the seed, the program built and warmed on the cell's
  shapes;
- ``window(state, seconds, trace) -> run``: the measured window; a dict
  of what the metric readers read (``trace`` profiles a bounded slice);
- ``check(state, run) -> [(name, value, limit)]``: the output checks
  against the plain reference, once the window has closed and the
  program is closed;
- ``close(state)``: release the program's live objects before the
  check (its outputs stay in the state).
"""
