"""setup_s: from the process's start to the window's: imports, the
kernels' build or load, the inputs made from the seed, the warm-up."""


def read(run):
    return run.get("setup_s")
