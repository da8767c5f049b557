"""round_roofline: the least time of the profiled jobs' block rounds
(lib/counts.py round_bound_s, float32 peaks) over the time the card ran
kernels in the profiled slice, in percent."""

from benchmark.lib.counts import round_bound_s


def read(run):
    sl = run.get("slice")
    if run.get("kind") != "train" or sl is None or not sl["kernel_s"]:
        return None
    rounds = sum(j.get("rounds", 0) for j in run["jobs"] if j["profiled"])
    if not rounds:
        return None
    bound = rounds * round_bound_s(run["n"], run["d"], run["q"])
    return 100.0 * bound / sl["kernel_s"]
