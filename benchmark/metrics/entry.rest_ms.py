"""entry.rest_ms: the host time of a job's train() call (the program's
span train) less its solver/chunk, solver/upload and model/assemble
spans, a job, in the profiled slice: validation, the memo's fingerprint,
the norms, the staging and the finalize."""

from benchmark.lib.spans import self_ms


def read(run):
    return self_ms(run, "train", ("solver/chunk", "solver/upload",
                                  "model/assemble"))
