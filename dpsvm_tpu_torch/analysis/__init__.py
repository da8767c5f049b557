"""Static analysis of the port's host code: threadlint
(:mod:`~dpsvm_tpu_torch.analysis.threadlint` over the facts of
:mod:`~dpsvm_tpu_torch.analysis.concurrency_facts`), the concurrency
contracts of the threaded modules, committed under ``contracts/``.

The JAX package's other analyser, tpulint, reads XLA HLO; the port
compiles no XLA program, so it has no counterpart here (``cli lint``
without ``--threads`` says so)."""
