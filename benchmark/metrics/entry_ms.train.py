"""entry_ms.train: a job's train() wall time less the solver's own
SolveResult.train_seconds (the entry, X's upload and norms, staging,
the model's assembly), mean over the jobs outside the profiled slice."""


def read(run):
    if run.get("kind") != "train":
        return None
    js = [j for j in run["jobs"] if j["ok"] and not j["profiled"]]
    if not js:
        return None
    return 1e3 * sum(j["wall_s"] - j["train_s"] for j in js) / len(js)
