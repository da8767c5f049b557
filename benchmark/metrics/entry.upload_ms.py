"""entry.upload_ms: the device time of X's upload a job (the program's span
solver/upload: the padding, the host-to-device copy and the cast; the
norms lie outside), in the profiled slice."""

from benchmark.lib.spans import per


def read(run):
    return per(run, "solver/upload", "device_s", "train")
