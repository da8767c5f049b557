"""block.fold_ms: the device time of a block round's fold (the
program's span block/fold: the kernel-row GEMM, the kernel's elementwise
passes, the contraction into f and the alpha scatter) a round, in the
profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "block/fold", "device_s", "block/select")
