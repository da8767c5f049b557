"""block.select_ms: the device time of a block round's selection (the
program's span block/select) a round, in the profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "block/select", "device_s", "block/select")
