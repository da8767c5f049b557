"""entry.model_ms: the host time of the model's assembly a job (the
program's span model/assemble: SVMModel.from_dense gathers the support
vectors on the host), in the profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "model/assemble", "host_s", "train")
