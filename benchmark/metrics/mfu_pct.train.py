"""mfu_pct.train: the flops the jobs' block rounds need (lib/counts.py
round_flops, times outer_rounds) over the jobs' wall time at the
float32 peak, in percent; the jobs outside the profiled slice."""

from benchmark.lib.counts import PEAK_F32_FLOPS, round_flops


def read(run):
    if run.get("kind") != "train":
        return None
    js = [j for j in run["jobs"] if j["ok"] and not j["profiled"]]
    wall = sum(j["wall_s"] for j in js)
    if not wall:
        return None
    flops = sum(j["rounds"] for j in js) * round_flops(run["n"], run["d"],
                                                        run["q"])
    return 100.0 * flops / wall / PEAK_F32_FLOPS
