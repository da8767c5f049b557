"""block.round_ms: the solver's seconds over its block rounds
(sum train_seconds / sum outer_rounds) of the jobs outside the profiled
slice."""


def read(run):
    if run.get("kind") != "train":
        return None
    js = [j for j in run["jobs"] if j["ok"] and not j["profiled"]]
    rounds = sum(j["rounds"] for j in js)
    return 1e3 * sum(j["train_s"] for j in js) / rounds if rounds else None
