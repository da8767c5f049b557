"""train_s: the window's wall time over the jobs it completed, seconds a
trained model as the user calls train()."""


def read(run):
    if run.get("kind") != "train":
        return None
    ok = sum(1 for j in run["jobs"] if j["ok"])
    return run["window_s"] / ok if ok else None
