"""device_idle_pct.train: the share of the profiled slice of training
jobs in which no kernel, copy or memset ran, in percent."""


def read(run):
    sl = run.get("slice")
    if run.get("kind") != "train" or sl is None or not sl["window_s"]:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
