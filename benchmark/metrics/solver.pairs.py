"""solver.pairs: pair updates a job (SolveResult.iterations), mean over
the window's jobs."""


def read(run):
    if run.get("kind") != "train":
        return None
    js = [j for j in run["jobs"] if j["ok"]]
    return sum(j["pairs"] for j in js) / len(js) if js else None
