"""block.gather_ms: the device time of a block round's gather of the
working set's rows and K(W, W) (the program's span block/gather) a
round, in the profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "block/gather", "device_s", "block/select")
