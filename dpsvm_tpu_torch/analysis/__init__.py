"""Static analysis of the port's contracts.

The structural linter (the JAX package's tpulint): the paper's
contribution is structural (one gather per SMO sync, kernel rows as
dense products, no per-row host round trips, a fixed number of host
dispatches a step, no float64 on a device path), and so are the port's
hot paths. The JAX package reads those facts from compiled HLO; the port
compiles no program, so it records them from the eager ops that one
step of each hot entrypoint runs, on the CPU with no card attached, and
diffs them against committed budgets (``budgets/*.json``). ``cli lint
--check`` runs it; ``chip_smoke.py`` [lint] holds the card to the same
kernel calls, collectives, dispatches and host reads.

threadlint (``cli lint --threads``): the concurrency contracts of the
threaded host modules, committed under ``contracts/``.

Modules:
  op_facts          -- the recorder and its fact families
  extract           -- per-entry orchestration (run, record, collect)
  manifest          -- the canonical entrypoints and shapes
  budget            -- budget IO, drift diffing, verdicts, the lint runner
  concurrency_facts -- threadlint's facts over the Python source
  threadlint        -- threadlint's contracts and runner
"""

from dpsvm_tpu_torch.analysis.op_facts import (  # noqa: F401
    COLLECTIVE_KINDS,
    KERNEL_IDS,
    Recorder,
    kernel_wrappers,
    record,
)
