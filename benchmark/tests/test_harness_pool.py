"""The train-jobs mix: no two consecutive jobs share a host array, so
the port's one-entry memo of the last array misses on every job; the
pool holds fixed sets and one set drawn from the run's seed."""

import numpy as np

from conftest import make_cell


def test_consecutive_jobs_never_share_an_array():
    from dpsvm_tpu_torch.solver import solve

    cell = make_cell("mnist8m.block", "mnist8m", "train-jobs", rows=400)
    drv = cell.driver
    state = drv.setup(cell, 2**31 + 7, "cpu")
    pool = state["pool"]
    assert len({id(x) for x, _ in pool}) == len(pool) >= 3
    uploads = solve.MEMO_STATS["x_uploads"]
    hits = solve.MEMO_STATS["x_hits"]
    run = drv.window(state, 3.0, False)
    jobs = run["jobs"]
    assert len(jobs) >= 2
    # The warm-up trained pool[-1]; the window starts at pool[0].
    seq = [len(pool) - 1] + [j["pool"] for j in jobs]
    assert all(a != b for a, b in zip(seq, seq[1:]))
    assert solve.MEMO_STATS["x_uploads"] - uploads == len(jobs)
    assert solve.MEMO_STATS["x_hits"] == hits


def test_every_seed_trains_the_fixed_sets_and_one_of_its_own():
    cell = make_cell("mnist8m.block", "mnist8m", "train-jobs", rows=300)
    a = cell.driver.setup(cell, 1, "cpu")
    b = cell.driver.setup(cell, 2**31 + 5, "cpu")

    def sums(state, seeded):
        return sorted(float(x.sum()) for i, (x, _) in enumerate(
            state["pool"]) if (i in state["seeded"]) == seeded)

    assert len(a["pool"]) == 4 and len(a["seeded"]) == 1
    assert sums(a, False) == sums(b, False)
    assert set(sums(a, True)).isdisjoint(sums(b, True) + sums(b, False))
    again = cell.driver.setup(cell, 1, "cpu")
    assert again["seeded"] == a["seeded"]
    assert all(np.array_equal(x, y) for (x, _), (y, _) in
               zip(a["pool"], again["pool"]))
