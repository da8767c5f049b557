"""block.subproblem_ms: the device time of a block round's subproblem
(the program's span block/subproblem: kernel B1) a round, in the
profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "block/subproblem", "device_s", "block/select")
