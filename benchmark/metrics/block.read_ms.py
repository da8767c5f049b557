"""block.read_ms: the host time of the round loop's condition read (the
program's span block/read: the host waits there for the round's device
work) a round, in the profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "block/read", "host_s", "block/select")
